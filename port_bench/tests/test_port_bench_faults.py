"""A run with the timed path broken underneath comes out not correct, for
each fault a one-card cell of this benchmark can have: an answer altered
where it is produced (inference), a step that leaves its state unchanged,
and a loss over half of the batch (training). The cells run on one card,
so no exchange between cards can be left out."""
import torch

from mobi_tpu_torch import training
from mobi_tpu_torch.models.diffusion import MobiDiffusion
from port_bench.tests.helpers import run_cell


def test_an_altered_answer_is_caught(tiny_bench, monkeypatch):
    decode = MobiDiffusion.decode_sample

    def altered(self, *args, **kw):
        out = decode(self, *args, **kw)
        out["camera"] = out["camera"].clone()
        out["camera"][:, :8, :8] = -out["camera"][:, :8, :8]
        return out

    monkeypatch.setattr(MobiDiffusion, "decode_sample", altered)
    rc, res, _, _ = run_cell(tiny_bench, "tiny_bulk")
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["camera_rel_l2"]["value"] > res["checks"]["camera_rel_l2"]["limit"]
    assert res["checks"]["lidar_rel_l2"]["value"] <= res["checks"]["lidar_rel_l2"]["limit"]


def test_a_step_that_leaves_its_state_unchanged_is_caught(tiny_bench, monkeypatch):
    monkeypatch.setattr(training.MaskedAdamW, "update", lambda self: self.zero_grad())
    rc, res, _, _ = run_cell(tiny_bench, "tiny_train")
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["change_gap"]["value"] == 1.0


def test_a_loss_over_half_the_batch_is_caught(tiny_bench, monkeypatch):
    loss = MobiDiffusion.training_loss

    def half(self, batch, generator=None, *, t=None, noise=None, drop=None):
        def cut(x):
            return {k: cut(v) for k, v in x.items()} if isinstance(x, dict) else x[: x.shape[0] // 2]

        rows = t.shape[0] // 2
        return loss(self, cut(batch), generator, t=t[:rows], noise=noise[:rows], drop=drop)

    monkeypatch.setattr(MobiDiffusion, "training_loss", half)
    rc, res, _, _ = run_cell(tiny_bench, "tiny_train")
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["loss_gap"]["value"] > res["checks"]["loss_gap"]["limit"]
    assert torch.isfinite(torch.tensor([c["value"] for c in res["checks"].values()])).all()
