"""Host-paged register engine: logical registers beyond device capacity.

Analog of the reference's LRU host-paging engine for huge register-count
workloads (reference: include/marin/engine_gpu.h:2172-2644 `engine_gpu` —
logical regs spill to host `_backing` vectors, `_logical_to_slot` +
`_slot_clock` LRU). TPU version: wraps ANY inner Engine whose reg_count is
the device slot budget; cold registers live as host numpy arrays and move
via get_raw/set_raw (device_put/get streams underneath the jax engines).

Every primitive op pins its operands resident (evicting the
least-recently-used non-pinned slot) and delegates with slot indices; the
base-class derived ops (pow, addsub, square_mul_seq, checkpoints) then
work unchanged on logical indices.

Eviction is write-back with DIRTY TRACKING: a page-in keeps the host
copy, and ops mark only the registers they WRITE. Evicting a clean
register is free (the host copy is still current) — so read-mostly
access patterns (the stage-2 baby table scanned by every giant step,
prepared ECM quads) pay one host->device transfer per residency instead
of a full round trip per eviction.

Port: a copy of prmers_tpu/engine/paged.py. PagedEngine is the original;
it wraps either engine of the port (FourStepEngine, whose multiplicands
travel with their spectral flag through get_raw_tagged/set_raw_tagged,
and TorchEngine). device_reg_budget is the port's own: it reads the
card's free memory (torch.cuda.mem_get_info, plus what torch's allocator
holds unused) in place of a v5e's 15.5 GiB, and charges each register
the bytes the chosen engine holds for it and the tables and an op's
temporaries at the per-word sizes measured on an H100 (OVERHEAD_BYTES),
in place of the reference's 11 register-equivalents.
"""

from __future__ import annotations

import numpy as np

from .api import Engine, Reg


class PagedEngine(Engine):
    def __init__(self, inner: Engine, logical_count: int):
        super().__init__(inner.p, logical_count)
        assert logical_count >= inner.reg_count
        self.inner = inner
        self.slots = inner.reg_count
        self._slot_of: dict[int, int] = {}        # logical -> slot
        self._logical_at: list[int | None] = [None] * self.slots
        self._lru = [0] * self.slots
        self._clock = 0
        # evicted logical -> (raw dump, is_spectral): the tag must travel
        # with the page so a paged-out multiplicand survives the round trip
        self._host: dict[int, tuple[np.ndarray, bool]] = {}
        self._dirty = [False] * self.slots
        self.page_ins = 0
        self.page_outs = 0
        self.clean_evictions = 0

    # -- paging core -------------------------------------------------------
    def _touch(self, slot: int):
        self._clock += 1
        self._lru[slot] = self._clock

    def _ensure(self, *logical: int, write: tuple[int, ...] = ()
                ) -> list[int]:
        """Pin the logical registers resident; `write` lists the POSITIONS
        in `logical` the caller will mutate (marks those slots dirty and
        invalidates their kept host copies)."""
        pinned = set()
        out = []
        for lg in logical:
            if lg in self._slot_of:
                s = self._slot_of[lg]
            else:
                s = self._evict_one(pinned)
                old = self._logical_at[s]
                if old is not None:
                    if self._dirty[s] or old not in self._host:
                        self._host[old] = self.inner.get_raw_tagged(s)
                        self.page_outs += 1
                    else:
                        self.clean_evictions += 1  # host copy is current
                    del self._slot_of[old]
                if lg in self._host:
                    data, spec = self._host[lg]
                    self.inner.set_raw_tagged(s, data, spec)
                    self.page_ins += 1
                else:
                    self.inner.set_raw(
                        s, np.zeros(self.inner.get_size(), dtype=np.uint64))
                self._slot_of[lg] = s
                self._logical_at[s] = lg
                self._dirty[s] = False
            self._touch(s)
            pinned.add(s)
            out.append(s)
        for pos in write:
            s = out[pos]
            self._dirty[s] = True
            # the kept host copy is stale the moment the device writes
            self._host.pop(self._logical_at[s], None)
        return out

    def _evict_one(self, pinned: set[int]) -> int:
        free = [s for s in range(self.slots)
                if self._logical_at[s] is None and s not in pinned]
        if free:
            return free[0]
        cands = [s for s in range(self.slots) if s not in pinned]
        return min(cands, key=lambda s: self._lru[s])

    # -- helpers -----------------------------------------------------------
    def get_size(self) -> int:
        return self.inner.get_size()

    @property
    def widths(self) -> np.ndarray:
        return self.inner.widths

    def sync(self) -> None:
        self.inner.sync()

    # -- primitive ops (delegate with slot mapping) -------------------------
    def set(self, dst: Reg, a: int) -> None:
        (s,) = self._ensure(dst, write=(0,))
        self.inner.set(s, a)

    def copy(self, dst: Reg, src: Reg) -> None:
        sd, ss = self._ensure(dst, src, write=(0,))
        self.inner.copy(sd, ss)

    def square_mul(self, src: Reg, a: int = 1) -> None:
        (s,) = self._ensure(src, write=(0,))
        self.inner.square_mul(s, a)

    def set_multiplicand(self, dst: Reg, src: Reg) -> None:
        sd, ss = self._ensure(dst, src, write=(0,))
        self.inner.set_multiplicand(sd, ss)

    def mul(self, dst: Reg, src: Reg, a: int = 1) -> None:
        sd, ss = self._ensure(dst, src, write=(0,))
        self.inner.mul(sd, ss, a)

    def sub(self, src: Reg, a: int) -> None:
        (s,) = self._ensure(src, write=(0,))
        self.inner.sub(s, a)

    def add_small(self, src: Reg, a: int) -> None:
        (s,) = self._ensure(src, write=(0,))
        self.inner.add_small(s, a)

    def add(self, dst: Reg, src: Reg) -> None:
        sd, ss = self._ensure(dst, src, write=(0,))
        self.inner.add(sd, ss)

    def sub_reg(self, dst: Reg, src: Reg) -> None:
        sd, ss = self._ensure(dst, src, write=(0,))
        self.inner.sub_reg(sd, ss)

    # -- host exchange -----------------------------------------------------
    def get_digits(self, src: Reg) -> np.ndarray:
        (s,) = self._ensure(src)
        return self.inner.get_digits(s)

    def set_digits(self, dst: Reg, digits: np.ndarray) -> None:
        (s,) = self._ensure(dst, write=(0,))
        self.inner.set_digits(s, digits)

    def get_raw(self, src: Reg) -> np.ndarray:
        # a resident slot is authoritative (a kept host copy may only
        # exist for CLEAN residents, where both are identical)
        if src not in self._slot_of and src in self._host:
            return self._host[src][0].copy()
        (s,) = self._ensure(src)
        return self.inner.get_raw(s)

    def get_raw_tagged(self, src: Reg) -> tuple[np.ndarray, bool]:
        if src not in self._slot_of and src in self._host:
            data, spec = self._host[src]
            return data.copy(), spec
        (s,) = self._ensure(src)
        return self.inner.get_raw_tagged(s)

    def set_raw(self, dst: Reg, data: np.ndarray) -> None:
        (s,) = self._ensure(dst, write=(0,))
        self.inner.set_raw(s, data)

    def set_raw_tagged(self, dst: Reg, data: np.ndarray,
                       spectral: bool = False) -> None:
        (s,) = self._ensure(dst, write=(0,))
        self.inner.set_raw_tagged(s, data, spectral)


# Device bytes per transform word that an engine holds beside its
# registers: its tables and the peak of its ops' temporaries (a graph
# pool's blocks included). Phase 9 of chip_smoke.py measures both on an
# H100 (torch.cuda.max_memory_allocated over an engine's build and its
# ops, less its registers: FourStepEngine 159.2 at n = 2^23, TorchEngine
# 537.4 at n = 81920, NVIDIA H100 80GB HBM3) and fails if either exceeds
# its charge here, these with ~20% to spare.
OVERHEAD_BYTES = {"jax": 640, "pallas": 192}


def register_bytes(n: int, backend: str = "jax") -> int:
    """Device bytes of one register: TorchEngine's slab row of n int64
    words; FourStepEngine's (R1, R2, C) int64 value and its out-carries,
    at most one int64 per 256 digits (T <= 4 units a row of C >= 1024);
    a multiplicand takes the same (R1, R2, C) words."""
    if backend == "pallas":
        return 8 * n + 8 * (n >> 8)
    return 8 * n


def free_device_bytes(device=None) -> int:
    """Bytes a new allocation can take: the card's free memory and what
    torch's caching allocator holds but does not use; on the CPU the
    host's available memory (also for device None without a card: the
    numpy backend asks with no device)."""
    import torch
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        free, _total = torch.cuda.mem_get_info(dev)
        return int(free + torch.cuda.memory_reserved(dev)
                   - torch.cuda.memory_allocated(dev))
    import os
    return int(os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))


def device_reg_budget(n: int, hbm_bytes: int | None = None, device=None,
                      backend: str = "jax") -> int:
    """How many n-word registers of the backend's engine ("jax":
    TorchEngine, "pallas": FourStepEngine) fit the device, after its
    tables and temporaries (OVERHEAD_BYTES per word). PRMERS_MAX_DEVICE_REGS
    sets the count and PRMERS_MEMLIM_MB (-memlim, MiB) the memory, as in
    the reference. Every primitive op pins at most two registers, so 2
    slots always suffice."""
    import os
    env = os.environ.get("PRMERS_MAX_DEVICE_REGS")
    if env:
        return max(int(env), 2)
    if hbm_bytes is None:
        memlim = os.environ.get("PRMERS_MEMLIM_MB")  # -memlim (MiB)
        if memlim:
            hbm_bytes = int(memlim) << 20
        else:
            hbm_bytes = free_device_bytes(device)
    usable = int(hbm_bytes * 0.95) - OVERHEAD_BYTES[backend] * n
    return max(usable // register_bytes(n, backend), 2)
