"""Hardware configuration of the simulated NPU core.

``NPUCoreConfig`` mirrors the paper's Table II simulator config (a
TPUv4-like core). Its fields are the *simulated* device's parameters,
inputs to the cost model and the simulators; they are not a
measurement of any chip. Copied from the reference package's
``npu/hw_config.py`` without the reference's TPU roofline constants.

``H100Roofline`` takes their place for the dry run
(``launch/dryrun.py``): data-sheet constants of one NVIDIA H100 SXM5
80GB in a cluster of 8-GPU nodes, the divisors of its roofline terms.
They are a model of a 256- or 512-GPU cluster, not a measurement.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class NPUCoreConfig:
    """Paper Table II: one physical NPU core (pNPU core)."""

    n_me: int = 4                  # matrix engines (systolic arrays)
    n_ve: int = 4                  # vector engines
    me_dim: int = 128              # 128x128 systolic array
    ve_lanes: int = 128            # 128 lanes ...
    ve_ops_per_lane: int = 8       # ... x 8 FP32 ops/cycle  (Table II)
    freq_hz: float = 1.05e9        # 1050 MHz
    sram_bytes: int = 128 * 1024 * 1024          # 128 MB on-chip
    hbm_bytes: int = 64 * 1024**3                # 64 GB
    hbm_bw: float = 1200e9                       # 1200 GB/s
    # ME preemption: pop partial sums (128) + pop weights (128) — §III-G
    ctx_switch_cycles: int = 256
    # memory isolation segment sizes — §III-C
    sram_segment: int = 2 * 1024 * 1024          # 2 MB
    hbm_segment: int = 1 * 1024**3               # 1 GB

    # ------------------------------------------------------------------
    @property
    def me_flops_per_cycle(self) -> float:
        """One ME: me_dim x me_dim MACs/cycle, 2 FLOPs per MAC."""
        return 2.0 * self.me_dim * self.me_dim

    @property
    def ve_elems_per_cycle(self) -> float:
        """One VE: lanes x ops-per-lane elementwise ops/cycle."""
        return float(self.ve_lanes * self.ve_ops_per_lane)

    @property
    def hbm_bytes_per_cycle(self) -> float:
        return self.hbm_bw / self.freq_hz

    def with_(self, **kw) -> "NPUCoreConfig":
        import dataclasses

        return dataclasses.replace(self, **kw)


DEFAULT_CORE = NPUCoreConfig()


@dataclass(frozen=True)
class H100Roofline:
    """Roofline constants of one H100 SXM5 80GB in the dry run's model
    of a cluster. Spec-sheet values, not measurements."""

    # NVIDIA H100 data sheet, SXM5: dense bf16 tensor-core peak (no
    # sparsity), at the 700 W power limit
    peak_flops_bf16: float = 989.4e12
    # the same data sheet: HBM3 bandwidth, 3.35 TB/s
    hbm_bw: float = 3.35e12
    # the same data sheet: 80 GB of HBM3 per GPU
    hbm_per_chip: int = 80 * 10**9
    # one 400 Gb/s InfiniBand NDR port per GPU (DGX H100 reference
    # design), 50e9 B/s: every axis of the production meshes is 16 wide,
    # so it spans two 8-GPU NVLink nodes and a ring is bounded by this
    # inter-node hop
    link_bw: float = 50e9


H100 = H100Roofline()
