"""Metrics aggregation and best-model tracking (the port's own copy of
llm_guided_asr_tpu/train/reporter.py, standard library only).

Rebuild of espnet2/train/reporter.py (Reporter/SubReporter): per-epoch,
per-phase weighted averages of scalar stats, best-epoch queries
(get_best_epoch, reporter.py:393), patience-based early stopping
(check_early_stopping, reporter.py:396), and serializable state so training
resume restores metric history (the same ``reporter.json`` as the JAX
package writes).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class _Acc:
    total: float = 0.0
    weight: float = 0.0

    def add(self, value: float, weight: float = 1.0):
        if value is None:
            return
        self.total += float(value) * float(weight)
        self.weight += float(weight)

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.weight if self.weight > 0 else None


class SubReporter:
    """Accumulates stats for one (epoch, phase); mirrors reporter.py:153."""

    def __init__(self, phase: str, epoch: int):
        self.phase = phase
        self.epoch = epoch
        self._accs: Dict[str, _Acc] = defaultdict(_Acc)
        self._count = 0
        self._start = time.perf_counter()

    def register(self, stats: Dict[str, float], weight: float = 1.0):
        self._count += 1
        for k, v in stats.items():
            if v is None:
                continue
            self._accs[k].add(float(v), weight)

    def log_interval(self, every: int, extra: str = "") -> Optional[str]:
        if self._count % every != 0:
            return None
        msg = f"{self.phase} epoch {self.epoch} iter {self._count}: " + ", ".join(
            f"{k}={a.mean:.4f}" for k, a in sorted(self._accs.items()) if a.mean is not None
        )
        if extra:
            msg += " " + extra
        logger.info(msg)
        return msg

    def finish(self) -> Dict[str, float]:
        out = {k: a.mean for k, a in self._accs.items() if a.mean is not None}
        out["time"] = time.perf_counter() - self._start
        out["iterations"] = self._count
        return out


class Reporter:
    """Epoch x phase x key store with best-epoch logic (reporter.py:274)."""

    def __init__(self):
        self.epoch = 0
        # stats[epoch][phase][key] = mean
        self.stats: Dict[int, Dict[str, Dict[str, float]]] = {}

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def start_phase(self, phase: str) -> SubReporter:
        return SubReporter(phase, self.epoch)

    def finish_phase(self, sub: SubReporter):
        self.stats.setdefault(sub.epoch, {})[sub.phase] = sub.finish()

    def get(self, epoch: int, phase: str, key: str) -> Optional[float]:
        return self.stats.get(epoch, {}).get(phase, {}).get(key)

    def get_best_epoch(self, phase: str, key: str, mode: str) -> Optional[int]:
        """Best epoch for (phase, key); mode in {'max','min'} (reporter.py:393)."""
        best_epoch, best_val = None, None
        for ep in sorted(self.stats):
            v = self.get(ep, phase, key)
            if v is None:
                continue
            if (
                best_val is None
                or (mode == "max" and v > best_val)
                or (mode == "min" and v < best_val)
            ):
                best_epoch, best_val = ep, v
        return best_epoch

    def sort_epochs(self, phase: str, key: str, mode: str) -> List[int]:
        """Epochs sorted best-first by (phase, key)."""
        eps = [ep for ep in self.stats if self.get(ep, phase, key) is not None]
        return sorted(
            eps, key=lambda e: self.get(e, phase, key), reverse=(mode == "max")
        )

    def check_early_stopping(self, patience: int, phase: str, key: str, mode: str) -> bool:
        best = self.get_best_epoch(phase, key, mode)
        if best is None:
            return False
        if self.epoch - best > patience:
            logger.info(
                f"early stop: no {phase}/{key} improvement for {self.epoch - best} epochs "
                f"(best at {best})"
            )
            return True
        return False

    def log_epoch(self):
        parts = []
        for phase, stats in self.stats.get(self.epoch, {}).items():
            kv = ", ".join(
                f"{k}={v:.4f}" for k, v in sorted(stats.items()) if isinstance(v, float)
            )
            parts.append(f"[{phase}] {kv}")
        logger.info(f"epoch {self.epoch} results: " + " | ".join(parts))

    # -- serialization for --resume -------------------------------------
    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "stats": {str(k): v for k, v in self.stats.items()}}

    def load_state_dict(self, d: dict):
        self.epoch = d["epoch"]
        self.stats = {int(k): v for k, v in d["stats"].items()}

    def dump(self, path):
        with open(path, "w") as f:
            json.dump(self.state_dict(), f, indent=1)

    @classmethod
    def load(cls, path) -> "Reporter":
        r = cls()
        with open(path) as f:
            r.load_state_dict(json.load(f))
        return r
