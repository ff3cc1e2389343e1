"""Device choice for prmers_tpu_torch (counterpart of prmers_tpu/jaxconf.py).

The device is always explicit. The default is the CUDA card; when none is
present the port raises instead of quietly running on the CPU. The CPU
runs only when a caller asks for it (`device="cpu"`, as the tests do), and
then every kernel wrapper takes its plain torch version.
"""

from __future__ import annotations

import torch


def device(name: str | torch.device | None = None) -> torch.device:
    """Resolve a device name ("cuda", "cuda:N" or "cpu"; None = "cuda")."""
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "prmers_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain torch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
