"""Host-side computation helpers: keep prep math off the card.

Port of ``sba_tpu/utils/host.py`` with the torch meaning of each helper.
sba_tpu scopes host math to JAX's CPU backend because its TPU runtime
taxes every device sync once the first read-back has happened; on the
card the same discipline holds for a simpler reason: host prep belongs
on the host, and tensors move in one direction (host -> card) at the end
of prep.

- `host_cpu_device()` is torch's CPU device;
- `accel_device()` is the CUDA card (device 0), and raises when there is
  none: the port's entry points default to "cuda" and fail without a
  card;
- `on_host()` scopes torch's default device to the CPU;
- `machine_cache_dir()` keys a cache directory on the CPU's flags, as in
  sba_tpu.
"""

from __future__ import annotations

import contextlib

import torch


def host_cpu_device() -> torch.device:
    """The process-local CPU device."""
    return torch.device("cpu")


def accel_device() -> torch.device:
    """The CUDA card the bulk device work runs on (the current CUDA
    device); raises RuntimeError when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("accel_device: no CUDA device available")
    return torch.device("cuda", torch.cuda.current_device())


@contextlib.contextmanager
def on_host():
    """Scope torch's default device to the CPU: tensors made without an
    explicit device inside this context live on the host."""
    prev = torch.get_default_device()
    torch.set_default_device("cpu")
    try:
        yield
    finally:
        torch.set_default_device(prev)


def machine_cache_dir(base_dir: str) -> str:
    """A per-machine-type subdirectory of `base_dir` (made if missing),
    keyed on the CPU's feature flags: a cache of compiled host code must
    not be reused on a host with other features."""
    import hashlib
    import os

    tag = "generic"
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    tag = hashlib.md5(line.encode()).hexdigest()[:10]
                    break
    except OSError:
        pass
    path = os.path.join(base_dir, tag)
    os.makedirs(path, exist_ok=True)
    return path
