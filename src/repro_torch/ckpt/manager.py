"""Dedup-aware checkpointing (the port of ``repro.ckpt.manager``).

  * **dedup**: a merged workload's shared buffers are written once — the
    checkpoint stores the ParamStore layout (buffers + bindings) rather than
    per-model trees, so checkpoint size tracks *resident* bytes;
  * **atomicity**: write to ``step_XXXXXXXX.ckpt.tmp``, ``fsync``, then
    ``os.replace`` — a crash mid-save never corrupts the latest checkpoint;
  * **latest-pointer**: the ``LATEST`` file holds the newest complete step;
  * **resume-exact**: optimizer state and step counter round-trip bitwise,
    and the synthetic data pipeline is a pure function of the step;
  * **reshard-on-load**: leaves are stored as host numpy; ``restore``
    places them on the ``device`` or under the ``shardings`` the caller
    names (``ckpt.reshard``).

numpy has no bfloat16, so a bfloat16 leaf is stored as its bits
(:class:`HostBf16`: uint16 with a ``bfloat16`` label, the wire codec's
convention), never through ``ml_dtypes``.  A checkpoint is a pickle of the
port's own classes (``OptState`` of ``repro_torch.train.optimizer``); only
load files this program wrote.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.store import ParamStore
from repro_torch.distributed.partitioning import put
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import map_tree


@dataclasses.dataclass(frozen=True)
class HostBf16:
    """A bfloat16 leaf on the host: its bits as uint16."""

    bits: np.ndarray
    dtype: str = "bfloat16"


def _host(x):
    if not isinstance(x, torch.Tensor):
        return x
    t = x.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return HostBf16(t.view(torch.int16).numpy().view(np.uint16))
    return t.numpy()


def _to_host(tree):
    """Tensors -> host numpy (bf16 as :class:`HostBf16`); other leaves
    (binding strings, ints, numpy arrays) pass through untouched."""
    return map_tree(_host, tree)


def _tensor(x) -> Optional[torch.Tensor]:
    """The host leaf ``x`` as a CPU tensor, or None for a non-array leaf."""
    if isinstance(x, HostBf16):
        return torch.from_numpy(x.bits.view(np.int16)).view(torch.bfloat16)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    return None


def _on_device(x, device: torch.device):
    t = _tensor(x)
    return x if t is None else t.to(device)


def _under(x, sharding):
    t = _tensor(x)
    return x if t is None else put(sharding, t)


def _atomic_write(path: str, write) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.ckpt")

    # -- save -----------------------------------------------------------------

    def save(self, state: Any, step: int) -> str:
        payload = {"step": step, "state": _to_host(state)}
        final = self._path(step)
        _atomic_write(final, lambda f: pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL))
        _atomic_write(os.path.join(self.directory, "LATEST"),
                      lambda f: f.write(str(step).encode()))
        self._gc()
        return final

    def save_store(self, store: ParamStore, step: int, extra: Optional[dict] = None) -> str:
        """Dedup-aware: unique buffers once + bindings (tiny)."""
        payload = {"buffers": dict(store.buffers), "bindings": store.bindings, "extra": extra}
        return self.save(payload, step)

    # -- restore ----------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.directory, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip())

    def restore(self, step: int, device=None, shardings: Any = None):
        """The state saved at ``step``, its arrays as tensors under
        ``shardings`` (a tree mirroring the state) or else on ``device``
        (default ``cuda``)."""
        with open(self._path(step), "rb") as f:
            state = pickle.load(f)["state"]
        if shardings is not None:
            return map_tree(_under, state, shardings)
        dev = resolve_device(device)
        return map_tree(lambda x: _on_device(x, dev), state)

    def restore_latest(self, device=None, shardings: Any = None):
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(step, device, shardings)

    def restore_store(self, step: Optional[int] = None, device=None):
        """(ParamStore, extra) of the store saved at ``step`` (default the
        latest), its buffers on ``device``; (None, None) if there is none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        payload = self.restore(step, device)
        return ParamStore(payload["buffers"], payload["bindings"]), payload.get("extra")

    # -- gc ---------------------------------------------------------------------

    def _gc(self):
        ckpts = sorted(f for f in os.listdir(self.directory) if f.endswith(".ckpt"))
        for f in ckpts[: -self.keep]:
            os.remove(os.path.join(self.directory, f))

    def all_steps(self) -> list:
        return sorted(int(f[len("step_"):-len(".ckpt")])
                      for f in os.listdir(self.directory) if f.endswith(".ckpt"))
