"""Checkpoint save and restore, crash-save and partial loads (mobi_tpu
checkpoint.py), in the port's own format.

  * `CheckpointManager` keeps periodic and best-metric checkpoints (the
    reference's ModelCheckpoint) with the retention of the orbax
    CheckpointManager that the JAX package sets up (max_to_keep, best_fn
    m[monitor], best_mode "min"), step for step;
  * `restore_partial` and `delete_by_prefix`: the reference's strict=False
    load with ignore_keys, on state-dict names;
  * `install_crash_save`: checkpoint on SIGUSR1 and SIGTERM, stacks (or pdb)
    on SIGUSR2.

A checkpoint directory holds one directory per step, named by the integer
step as orbax names them, with torch.save files: `model.pt` (the model's
whole state dict), `optimizer.pt` (the inner optimizer's state dict, the
update count, the accumulation step and the accumulator), `ema.pt` (the
LitEma shadow and its update count) when the state keeps one, and
`meta.json` (the format tag, the step and the metrics).

Multi-process runs: every rank calls `save` and `restore`. A save of a
sharded state gathers it whole (the collective of `parallel.distributed.
replicate_to_host`, with the host copy on rank 0 only), and rank 0 alone
writes and prunes; a restore reads the same directory on every rank and
keeps each rank's pieces. The files are the same as a one-process run's.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from mobi_tpu_torch.parallel import distributed as pdist
from mobi_tpu_torch.parallel.mesh import model_sharding

FORMAT = "mobi_tpu_torch.checkpoint/1"
META = "meta.json"


def is_step_dir(path: str) -> bool:
    """Whether `path` is one step of a checkpoint the port wrote."""
    try:
        with open(os.path.join(path, META)) as f:
            return json.load(f).get("format") == FORMAT
    except (OSError, ValueError):
        return False


def _preserved(infos: List[Tuple[int, Dict[str, float]]], n: Optional[int],
               best_fn: Optional[Callable]) -> List[bool]:
    """Which checkpoints (in step order) orbax keeps: the latest n without a
    best_fn (LatestN), else the n best by best_fn, lowest first (BestN with
    reverse=True). Every save passes a metrics dict, as the JAX package's
    does, so a dict without the monitored key raises KeyError here."""
    if n is None or len(infos) <= n:
        return [True] * len(infos)
    if best_fn is None:
        return [False] * (len(infos) - n) + [True] * n
    if n == 0:
        return [False] * len(infos)
    ranked = sorted(enumerate(infos), key=lambda item: best_fn(item[1][1]), reverse=True)
    keep = {i for i, _ in ranked[-n:]}
    return [i in keep for i in range(len(infos))]


class CheckpointManager:
    """Top-k checkpoints of a `training.TrainState` in `ckpt_dir`.

    As orbax behaves under the JAX package's options: a save of a step at or
    below the latest one is skipped (returns False); after a save the
    checkpoints beyond `max_to_keep` are deleted, the latest first when no
    `monitor` is set, else the worst by metrics[monitor] (lower is better),
    the new one included; a metrics dict without the monitored key raises
    KeyError once there are more than `max_to_keep` checkpoints, after the
    new step is written and before anything is deleted. Saves are
    synchronous, so `wait` has nothing to wait for."""

    def __init__(self, ckpt_dir: str, max_to_keep: Optional[int] = 5, monitor: Optional[str] = None):
        os.makedirs(ckpt_dir, exist_ok=True)
        self.directory = os.path.abspath(ckpt_dir)
        self.max_to_keep = max_to_keep
        self.best_fn = (lambda m: m[monitor]) if monitor else None
        self._infos: List[Tuple[int, Dict[str, float]]] = []
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if name.isdigit() and is_step_dir(path):
                with open(os.path.join(path, META)) as f:
                    self._infos.append((int(name), json.load(f)["metrics"]))
        self._infos.sort()

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> List[int]:
        return [s for s, _ in self._infos]

    def latest_step(self) -> Optional[int]:
        return self._infos[-1][0] if self._infos else None

    def save(self, step: int, state: Any, metrics: Optional[dict] = None) -> bool:
        """Write `state` as `step`: a TrainState (.model, .opt, .ema), or a
        dict of named parts (a state dict each, as the autoencoder trainer's
        {"vae", "loss"}), one `<part>.pt` a part."""
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        rank0 = pdist.is_main_process()
        sharding = None if isinstance(state, dict) else model_sharding(state.model)
        if isinstance(state, dict):
            payload = ({name: {k: v.detach().cpu() for k, v in part.items()} for name, part in state.items()}
                       if rank0 else None)
        elif sharding is not None and sharding.sharded:
            # the pieces are gathered whole on every rank (a collective);
            # rank 0 alone copies them to the host
            payload = sharding.host_state(state, keep=rank0)
        else:
            # every rank holds the whole state: rank 0 writes its own
            # tensors, torch.save streaming them off the card
            payload = pdist.state_payload(state) if rank0 else None
        if rank0:
            self._write(step, payload, metrics)
        pdist.barrier("checkpoint_save")
        self._infos.append((int(step), metrics))
        keep = _preserved(self._infos, self.max_to_keep, self.best_fn)
        for (s, _), kept in zip(list(self._infos), keep):
            if not kept and rank0:
                shutil.rmtree(self.step_dir(s))
        self._infos = [info for info, kept in zip(self._infos, keep) if kept]
        return True

    def _write(self, step: int, payload: Dict[str, Any], metrics: Dict[str, float]) -> None:
        """The step's files from a whole state in replicate_to_host's form."""
        final = self.step_dir(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for part, value in payload.items():
            if value is not None:
                torch.save(value, os.path.join(tmp, f"{part}.pt"))
        with open(os.path.join(tmp, META), "w") as f:
            json.dump({"format": FORMAT, "step": int(step), "metrics": metrics}, f)
        os.rename(tmp, final)

    def restore(self, step: Optional[int] = None, state: Any = None):
        """The checkpoint of `step` (default: the latest; None when there is
        none). With `state` (a TrainState built like the saved one) the
        model's parameters, the optimizer, the EMA shadow and the step are
        loaded into it bit for bit and it is returned; without, a dict of
        what the files hold, on the CPU."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return read_step(self.step_dir(step), state)

    def wait(self) -> None:
        pass


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def read_step(path: str, state: Any = None, parts: Sequence[str] = ("model", "optimizer", "ema")):
    """One step directory: loaded into `state`, or as a dict {"step",
    "metrics", and each of `parts`: "model", "optimizer", "ema" or the
    parts of a dict save} (None for an absent file)."""
    if not is_step_dir(path):
        raise ValueError(f"{path} is not a checkpoint step written by mobi_tpu_torch")
    with open(os.path.join(path, META)) as f:
        meta = json.load(f)
    files = {name: os.path.join(path, f"{name}.pt") for name in parts}
    loaded = {name: _load(p) if os.path.exists(p) else None for name, p in files.items()}
    if state is None:
        return {"step": meta["step"], "metrics": meta["metrics"], **loaded}
    sharding = model_sharding(state.model)
    if sharding is not None:  # each rank keeps its pieces of the whole tensors
        loaded["model"] = sharding.local_model_state(loaded["model"])
        if state.opt is not None:
            loaded["optimizer"] = sharding.local_optimizer_state(state.opt, loaded["optimizer"])
        if state.ema is not None:
            loaded["ema"] = dict(loaded["ema"], shadow=sharding.local_ema_shadow(loaded["ema"]["shadow"]))
    state.model.load_state_dict(loaded["model"], strict=True)
    if state.opt is not None:
        load_optimizer_state(state.opt, loaded["optimizer"])
    if state.ema is not None:
        with torch.no_grad():
            for name, value in loaded["ema"]["shadow"].items():
                state.ema.shadow[name].copy_(value)
        state.ema.num_updates = loaded["ema"]["num_updates"]
    state.step = meta["step"]
    return state


def load_optimizer_state(opt, saved: Dict[str, Any]) -> None:
    """A MaskedAdamW's saved state into `opt`, bit for bit. torch's
    Optimizer.load_state_dict casts every floating state tensor to its
    parameter's dtype; the saved dtypes (a bf16 first moment) are put back."""
    opt.inner.load_state_dict(saved["inner"])
    for p, st in zip(opt.params, (saved["inner"]["state"].get(i) for i in range(len(opt.params)))):
        for key, value in (st or {}).items():
            if isinstance(value, torch.Tensor) and opt.inner.state[p][key].dtype != value.dtype:
                opt.inner.state[p][key] = value.to(device=p.device)
    opt.count, opt.mini_step = saved["count"], saved["mini_step"]
    opt._acc = None if saved["acc"] is None else [a.to(p.device) for a, p in zip(saved["acc"], opt.params)]


def delete_by_prefix(state_dict: Dict[str, Any], ignore_keys: Sequence[str]) -> Dict[str, Any]:
    """Drop the entries whose name starts with any of `ignore_keys` (the
    reference's ignore_keys)."""
    if not ignore_keys:
        return dict(state_dict)
    return {k: v for k, v in state_dict.items() if not any(k.startswith(ik) for ik in ignore_keys)}


def restore_partial(model_or_state_dict, loaded: Dict[str, Any], ignore_keys: Sequence[str] = ()):
    """strict=False load: the entries of `loaded` (less `ignore_keys`) over
    the base's of the same name, where a shape differs a ValueError. The
    base is a state dict, or a module, which the merged state dict is
    loaded into. Returns the merged state dict (the base's names only)."""
    module = model_or_state_dict if isinstance(model_or_state_dict, torch.nn.Module) else None
    base = module.state_dict() if module is not None else model_or_state_dict
    merged = dict(base)
    for k, v in delete_by_prefix(loaded, ignore_keys).items():
        if k not in base:
            continue
        v = torch.as_tensor(v)
        if tuple(base[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: have {tuple(base[k].shape)}, ckpt {tuple(v.shape)}")
        merged[k] = v.to(dtype=base[k].dtype)
    if module is not None:
        module.load_state_dict(merged, strict=True)
    return merged


def install_crash_save(save_fn: Callable[[], None],
                       post_mortem_fn: Optional[Callable[[Any], None]] = None) -> Dict[int, Any]:
    """SIGUSR1 -> checkpoint now; SIGTERM -> checkpoint, then exit with 143;
    SIGUSR2 -> post-mortem: every thread's stack on stderr, and pdb at the
    interrupted frame when stdin is a tty or MOBI_PDB=1 (the reference's
    melk and divein). `post_mortem_fn(frame)` replaces the post-mortem.
    Returns the handlers it replaced, by signal."""

    def _usr1(signum, frame):
        save_fn()

    def _term(signum, frame):
        save_fn()
        raise SystemExit(143)

    def _usr2(signum, frame):
        if post_mortem_fn is not None:
            post_mortem_fn(frame)
            return
        import faulthandler
        import sys

        print("SIGUSR2: dumping all thread stacks", file=sys.stderr, flush=True)
        faulthandler.dump_traceback(file=sys.stderr)
        if os.environ.get("MOBI_PDB") == "1" or (hasattr(sys.stdin, "isatty") and sys.stdin.isatty()):
            import pdb

            pdb.Pdb().set_trace(frame)

    handlers = {signal.SIGUSR1: _usr1, signal.SIGTERM: _term, signal.SIGUSR2: _usr2}
    return {sig: signal.signal(sig, handler) for sig, handler in handlers.items()}
