"""The port's checkpoints and loggers (mobi_tpu_torch/checkpoint.py,
utils/loggers.py) against the JAX package's (mobi_tpu/checkpoint.py on
orbax, mobi_tpu/utils/loggers.py), on the CPU.

Exact throughout: the loggers write the same bytes; the CheckpointManager
keeps the same steps as orbax under the JAX package's options, save for
save, and raises where it raises; a checkpoint restores the model, the
optimizer, the EMA shadow and the step bit for bit, and training continues
from it bit for bit.
"""
import logging
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from mobi_tpu import checkpoint as jckpt
from mobi_tpu.utils import loggers as jloggers
from mobi_tpu_torch import checkpoint as tckpt
from mobi_tpu_torch import convert
from mobi_tpu_torch import training as ttraining
from mobi_tpu_torch.models import diffusion as tdiff
from mobi_tpu_torch.utils import loggers as tloggers
from tests.test_diffusion import TINY, make_batch
from tests.test_torch_models import few_torch_threads, numpy_batch, port_config, tiny_cond_stage  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = "val/loss_simple"
RECORDS = [({"train/loss": 0.5, "train/step": 1}, None), ({"val/loss": 0.25}, 2),
           ({"train/loss": 0.125, "note": "a,b", "flag": None}, 3), ({"train/loss": float("nan")}, None),
           ({"imagelog/mse": 3, "train/loss": 1e-7}, 5)]


def test_loggers_write_the_same_bytes_as_jax(tmp_path):
    """One record sequence (new keys, strings, None, ints, nan) through
    jsonl + csv in both packages: byte-identical files, the csv header grown
    and rewritten in place."""
    for pkg, name in ((jloggers, "jax"), (tloggers, "port")):
        logger = pkg.MultiLogger([pkg.JsonlLogger(str(tmp_path / name)), pkg.CsvLogger(str(tmp_path / name))])
        for rec, step in RECORDS:
            logger.log(rec, step=step)
        logger.close()
    for f in ("metrics.jsonl", "metrics.csv"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    assert (tmp_path / "port" / "metrics.csv").read_text().splitlines()[0] == (
        "train/loss,train/step,val/loss,step,note,flag,imagelog/mse")


def test_wandb_logger_is_gated(tmp_path):
    try:
        import wandb  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError) as want:
            jloggers.WandbLogger(str(tmp_path))
        with pytest.raises(ImportError) as got:
            tloggers.WandbLogger(str(tmp_path))
        assert str(got.value) == str(want.value) and "pip install wandb" in str(got.value)
    else:
        assert tloggers._NAMED["wandb"] is tloggers.WandbLogger


@pytest.mark.parametrize("spec", [
    None, "csv", "testtube", "jsonl", {"target": "pytorch_lightning.loggers.TestTubeLogger",
                                       "params": {"name": "run", "save_dir": "ignored"}},
    {"target": "pytorch_lightning.loggers.CSVLogger"}, {"target": "Logger"}, "nope", "wandb",
])
def test_logger_from_config_forms(tmp_path, spec):
    """By name and by target, unknown names and the wandb gate: the same
    backends (jsonl always first) or the same error in both packages."""
    cfg = {"lightning": {"logger": spec}}
    results = []
    for pkg, name in ((jloggers, "jax"), (tloggers, "port")):
        try:
            stack = pkg.logger_from_config(cfg, str(tmp_path / name))
            results.append([type(b).__name__ for b in stack.backends])
        except (ValueError, ImportError) as e:
            results.append((type(e).__name__, str(e)))
    assert results[0] == results[1]
    if spec is None:
        assert results[1] == ["JsonlLogger"]


class _JaxSaves:
    """The JAX package's CheckpointManager on a dummy tree."""

    def __init__(self, d, k, monitor):
        self.m = jckpt.CheckpointManager(d, max_to_keep=k, monitor=monitor)

    def save(self, step, metrics):
        try:
            self.m.save(step, {"x": np.zeros(2, np.float32)}, metrics=metrics)
            self.m.wait()
        except Exception as e:
            try:
                self.m.wait()
            except Exception:
                pass
            return type(e).__name__
        return "ok"

    def steps(self):
        return sorted(self.m._mgr.all_steps()), self.m.latest_step()


class _PortSaves:
    def __init__(self, d, k, monitor):
        self.m = tckpt.CheckpointManager(d, max_to_keep=k, monitor=monitor)
        self.state = types.SimpleNamespace(model=torch.nn.Linear(2, 2), opt=None, ema=None)

    def save(self, step, metrics):
        try:
            self.m.save(step, self.state, metrics=metrics)
        except Exception as e:
            return type(e).__name__
        return "ok"

    def steps(self):
        return self.m.all_steps(), self.m.latest_step()


NAN = float("nan")
RETENTION = {
    # train.py at 16 steps (val and save every 8, top 2), then --resume to 18:
    # the final save without metrics raises once 3 checkpoints exist
    "cli_then_resume": (2, L, [[(8, {L: 1.0}), (16, {L: 0.5}), (16, None)], [(18, None)]]),
    "cli_resume_on_val": (2, L, [[(8, {L: 1.0}), (16, {L: 0.5}), (16, None)], [(18, {L: 0.7}), (18, None)]]),
    "new_worst_dropped": (2, L, [[(2, {L: 0.5}), (4, {L: 1.0}), (6, {L: 2.0})]]),
    "older_step_skipped": (2, L, [[(4, {L: 1.0}), (2, {L: 0.5}), (4, {L: 0.1})]]),
    "no_metrics_within_k": (2, L, [[(2, {L: 0.5}), (3, None)]]),
    "no_metrics_reloaded": (2, L, [[(2, {L: 0.5}), (3, None)], [(4, {L: 0.4})]]),
    "other_key": (2, L, [[(2, {L: 1.0}), (4, {"x": 0.1}), (6, {L: 2.0})]]),
    "ties": (2, L, [[(2, {L: 1.0}), (4, {L: 1.0}), (6, {L: 1.0})]]),
    "nan": (2, L, [[(2, {L: NAN}), (4, {L: 0.5}), (6, {L: 0.7}), (8, {L: 0.1})]]),
    "keep_one": (1, L, [[(2, {L: 0.5}), (4, {L: 0.4}), (4, None)], [(6, {L: 0.9})]]),
    "keep_all": (None, L, [[(2, {L: 0.5}), (4, None), (6, {L: 0.9})]]),
    "latest_without_monitor": (2, None, [[(2, {L: 0.5}), (3, {L: 0.1}), (4, None)], [(5, None)]]),
}


@pytest.mark.parametrize("case", sorted(RETENTION))
def test_retention_matches_orbax(tmp_path, case):
    """The same save sequence, each inner list one manager (a new process,
    as on --resume): after every save the same outcome (saved, or the
    exception), the same retained steps and the same latest step."""
    k, monitor, phases = RETENTION[case]
    logging.disable(logging.WARNING)  # orbax logs every save
    try:
        traces = []
        for cls, name in ((_JaxSaves, "jax"), (_PortSaves, "port")):
            trace = []
            for phase in phases:
                m = cls(str(tmp_path / name), k, monitor)
                trace.append(("open",) + m.steps())
                for step, metrics in phase:
                    trace.append((step, m.save(step, metrics)) + m.steps())
            traces.append(trace)
    finally:
        logging.disable(logging.NOTSET)
    assert traces[1] == traces[0]
    assert sorted(int(d) for d in os.listdir(tmp_path / "port") if d.isdigit()) == traces[1][-1][2]


def test_restore_partial_and_delete_by_prefix_keep_the_same_names():
    """JAX works on nested trees and dotted paths, the port on state-dict
    names: the same prefixes keep and drop the same names, and a partial
    load overlays the same values; a shape mismatch raises in both."""
    rng = np.random.default_rng(0)
    names = ["model.diffusion_model.a.weight", "model.diffusion_model.ab.weight", "model.other.bias",
             "first_stage_model.encoder.conv_in.weight", "proj_out.weight"]
    shapes = {n: (2, 3) if n.endswith("weight") else (3,) for n in names}

    def nested(flat):
        tree = {}
        for n, v in flat.items():
            node = tree
            parts = n.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
        return tree

    def flatten(tree, path=""):
        out = {}
        for k, v in tree.items():
            p = f"{path}.{k}" if path else k
            out.update(flatten(v, p) if isinstance(v, dict) else {p: v})
        return out

    base = {n: np.zeros(s, np.float32) for n, s in shapes.items()}
    loaded = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items() if n != "proj_out.weight"}
    for ignore in ([], ["model.diffusion_model.a"], ["model"], ["first_stage_model.encoder", "proj"]):
        want = flatten(jckpt.delete_by_prefix(nested(loaded), ignore))
        got = tckpt.delete_by_prefix(loaded, ignore)
        assert sorted(got) == sorted(want)
        jmerged = flatten(jckpt.restore_partial(nested(base), nested(loaded), ignore))
        tmerged = tckpt.restore_partial({n: torch.from_numpy(v) for n, v in base.items()}, loaded, ignore)
        assert sorted(tmerged) == sorted(jmerged)
        for n in jmerged:
            np.testing.assert_array_equal(tmerged[n].numpy(), np.asarray(jmerged[n]), err_msg=n)
    bad = {"proj_out.weight": np.zeros((3, 2), np.float32)}
    with pytest.raises(ValueError, match="shape mismatch"):
        jckpt.restore_partial(nested(base), nested(bad))
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore_partial({n: torch.from_numpy(v) for n, v in base.items()}, bad)


@pytest.mark.parametrize("pkg", ["mobi_tpu", "mobi_tpu_torch"])
def test_crash_save_signals(pkg):
    """SIGUSR1 saves once and the run goes on; SIGTERM saves and exits with
    143: the same in a process of either package."""
    code = textwrap.dedent(f"""
        import os, signal
        from {pkg}.checkpoint import install_crash_save
        saves = []
        def save():
            saves.append(1)
            print("saved", len(saves), flush=True)
        install_crash_save(save)
        os.kill(os.getpid(), signal.SIGUSR1)
        print("running", len(saves), flush=True)
        os.kill(os.getpid(), signal.SIGTERM)
        print("not reached", flush=True)
    """)
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 143, res.stderr[-2000:]
    assert res.stdout.splitlines() == ["saved 1", "running 1", "saved 2"]


def tiny_state(accumulate=1, mu_dtype=None):
    model = tdiff.MobiDiffusion(port_config(TINY), device="cpu", seed=5, cond_stage_model=tiny_cond_stage(),
                                for_training=True)
    state, tx = ttraining.create_train_state(model, use_ema=True, accumulate_steps=accumulate,
                                             adam_mu_dtype=mu_dtype, device="cpu")
    return state, tx, ttraining.make_train_step(model, tx, device="cpu")


def snapshot(state):
    """Every tensor and counter the checkpoint must carry, cloned."""
    opt = state.opt
    return {
        "step": state.step,
        "model": {k: v.clone() for k, v in state.model.state_dict().items()},
        "opt": [{k: v.clone() if torch.is_tensor(v) else v for k, v in opt.inner.state[p].items()}
                for p in opt.params],
        "counts": (opt.count, opt.mini_step),
        "acc": None if opt._acc is None else [a.clone() for a in opt._acc],
        "ema": ({k: v.clone() for k, v in state.ema.shadow.items()}, state.ema.num_updates),
    }


def assert_bitwise(a, b, path="state"):
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_bitwise(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_bitwise(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.mark.parametrize("accumulate,mu_dtype", [(1, None), (2, torch.bfloat16)])
def test_checkpoint_round_trip_is_bitwise(tmp_path, accumulate, mu_dtype):
    """Three steps, a save, a fresh state restored from the directory: the
    model, the optimizer (a bf16 first moment stays bf16; the accumulator
    mid-way), the EMA and the step are equal bit for bit, and one more step
    from either gives the same state bit for bit."""
    batch = numpy_batch(make_batch(b=2, rng=np.random.default_rng(3)))
    state, tx, step_fn = tiny_state(accumulate, mu_dtype)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        state, _ = step_fn(state, batch, gen)
    mgr = tckpt.CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2, monitor=L)
    assert mgr.save(state.step, state, {L: 0.5}) and not mgr.save(state.step, state)
    saved = snapshot(state)
    fresh, _, fresh_step = tiny_state(accumulate, mu_dtype)
    tckpt.CheckpointManager(str(tmp_path / "ckpt")).restore(state=fresh)
    assert fresh.step == 3
    assert_bitwise(snapshot(fresh), saved)
    if mu_dtype is not None:
        assert all(fresh.opt.inner.state[p]["mu"].dtype == mu_dtype for p in fresh.opt.params)
    state, _ = step_fn(state, batch, torch.Generator().manual_seed(9))
    fresh, _ = fresh_step(fresh, batch, torch.Generator().manual_seed(9))
    assert_bitwise(snapshot(fresh), snapshot(state))


def test_load_checkpoint_reads_the_ports_directories(tmp_path):
    """convert.load_checkpoint: a manager directory gives its latest step, a
    step directory that step, use_ema the EMA shadow over the UNet,
    ignore_keys keeps the model's own values there; an orbax directory of
    the JAX package raises, naming the conversion."""
    batch = numpy_batch(make_batch(b=2, rng=np.random.default_rng(3)))
    state, _, step_fn = tiny_state()
    mgr = tckpt.CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=3)
    gen = torch.Generator().manual_seed(0)
    snaps = {}
    for _ in range(2):
        state, _ = step_fn(state, batch, gen)
        mgr.save(state.step, state)
        snaps[state.step] = snapshot(state)

    def fresh():
        return tdiff.MobiDiffusion(port_config(TINY), device="cpu", seed=7, cond_stage_model=tiny_cond_stage())

    for path, step in ((tmp_path / "ckpt", 2), (tmp_path / "ckpt" / "1", 1)):
        model = fresh()
        info = convert.load_checkpoint(model, str(path))
        assert info["step"] == step and not info["missing"] and not info["ema"]
        assert_bitwise(model.state_dict(), snaps[step]["model"])
    model = fresh()
    info = convert.load_checkpoint(model, str(tmp_path / "ckpt"), use_ema=True)
    assert info["ema"]
    for k, v in model.state_dict().items():
        want = snaps[2]["ema"][0][k[len("model.diffusion_model."):]] if k.startswith("model.diffusion_model.") \
            else snaps[2]["model"][k]
        assert torch.equal(v, want), k
    model = fresh()
    before = model.proj_out.weight.clone()
    info = convert.load_checkpoint(model, str(tmp_path / "ckpt"), ignore_keys=["proj_out"])
    assert torch.equal(model.proj_out.weight, before) and info["missing"] == ["proj_out.weight", "proj_out.bias"]
    (tmp_path / "orbax" / "5").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="convert.state_dict_from_jax"):
        convert.load_checkpoint(fresh(), str(tmp_path / "orbax"))
