"""Training-metrics logger backends (mobi_tpu utils/loggers.py).

The reference picks a PyTorch-Lightning logger from the config's
`lightning.logger` block, TestTube by default and W&B as the shipped
alternative. Here, as in the JAX package, the train loop drives a small
fan-out over append-only backends:

  * JsonlLogger: one JSON object per line in metrics.jsonl;
  * CsvLogger: a flat metrics.csv whose header grows as new keys appear
    (the file is rewritten in place when it grows);
  * WandbLogger: a thin `wandb` adapter, import-gated: constructing it
    without the package raises with the install hint.

`logger_from_config` maps the reference's logger names and targets onto
these. The same record sequence writes the same bytes as the JAX package.
"""
from __future__ import annotations

import inspect
import json
import os
from typing import Any, Dict, List, Optional


class JsonlLogger:
    """Append one JSON object per `log` call to <logdir>/metrics.jsonl."""

    def __init__(self, logdir: str, filename: str = "metrics.jsonl"):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, filename)

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        rec = dict(metrics)
        if step is not None:
            rec.setdefault("step", step)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def close(self):
        pass


class CsvLogger:
    """Flat CSV with a growing header (TestTube's metrics.csv): a record
    with new keys rewrites the file under the wider header; absent values
    are left empty."""

    def __init__(self, logdir: str, filename: str = "metrics.csv"):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, filename)
        self._keys: List[str] = []
        self._rows: List[Dict[str, Any]] = []

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        rec = dict(metrics)
        if step is not None:
            rec.setdefault("step", step)
        new_keys = [k for k in rec if k not in self._keys]
        self._rows.append(rec)
        if new_keys:
            self._keys.extend(new_keys)
            self._rewrite()
        else:
            with open(self.path, "a") as f:
                f.write(self._format_row(rec) + "\n")

    def _format_row(self, rec):
        return ",".join(
            json.dumps(rec[k]) if isinstance(rec.get(k), str)
            else ("" if rec.get(k) is None else repr(rec[k]))
            for k in self._keys
        )

    def _rewrite(self):
        with open(self.path, "w") as f:
            f.write(",".join(self._keys) + "\n")
            for rec in self._rows:
                f.write(self._format_row(rec) + "\n")

    def close(self):
        pass


class WandbLogger:
    """Weights & Biases adapter (the reference's config surface)."""

    def __init__(self, logdir: str, name: Optional[str] = None, offline: bool = False,
                 project: Optional[str] = None, id: Optional[str] = None):
        try:
            import wandb
        except ImportError as e:
            # the JAX package's message, word for word
            raise ImportError(
                "WandbLogger requires the `wandb` package (pip install "
                "wandb), which is not available in this environment; use "
                "the jsonl/csv backends instead"
            ) from e
        self._run = wandb.init(dir=logdir, name=name, id=id, project=project,
                               mode="offline" if offline else None)

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        self._run.log(dict(metrics), step=step)

    def close(self):
        self._run.finish()


class NullLogger:
    """Swallows everything (the stack of a process that does not log)."""

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        pass

    def close(self):
        pass


class MultiLogger:
    """Fan a `log` call out to every backend."""

    def __init__(self, backends: List[Any]):
        self.backends = list(backends)

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        for b in self.backends:
            b.log(metrics, step=step)

    def close(self):
        for b in self.backends:
            b.close()


_NAMED = {"jsonl": JsonlLogger, "csv": CsvLogger, "testtube": CsvLogger, "wandb": WandbLogger}


def logger_from_config(cfg: Optional[dict], logdir: str) -> MultiLogger:
    """The metrics logger stack of the config's `lightning.logger` block:

      lightning.logger: wandb                                  # by name
      lightning.logger: {target: ...WandbLogger, params: {...}}  # by target

    metrics.jsonl is always written; the block adds one backend, with the
    params its constructor accepts."""
    backends: List[Any] = [JsonlLogger(logdir)]
    spec = ((cfg or {}).get("lightning") or {}).get("logger")
    if spec:
        if isinstance(spec, str):
            name, params = spec.lower(), {}
        else:
            name = str(spec.get("target", "")).rsplit(".", 1)[-1].lower()
            name = name.replace("logger", "") or "testtube"
            params = dict(spec.get("params", {}))
        if name not in _NAMED:
            raise ValueError(f"unknown logger backend {name!r}; known: {sorted(_NAMED)}")
        cls = _NAMED[name]
        if cls is not JsonlLogger:
            accepted = set(inspect.signature(cls).parameters) - {"logdir"}
            backends.append(cls(logdir, **{k: v for k, v in params.items() if k in accepted}))
    return MultiLogger(backends)
