"""What the port's dry run is held to against the reference's.

One table for ``chip_smoke.py``'s dry-run cells, the cut-size tests and
``scripts/dryrun_sweep_check.py`` over all 64 live rows: per-device
FLOPs within ``DRYRUN_FLOPS_RTOL`` of the reference's, and collective
bytes per device within ``DRYRUN_COLL_RTOL`` of the reference's times a
row's expected ratio: ``DRYRUN_COLL_EXPECT`` of its kind, or its own in
``DRYRUN_COLL_EXPECT_CELLS``, each with its cause from the op-by-op
lists of ``scripts/dryrun_collectives.py`` (``PERF.md``, section 6,
adds the terms up).

The kinds' ratios. All but 0.1% of the dense rows' collective bytes are
all-reduces in both packages, and the ratio is a half, since the
reference's CPU compile all-reduces bf16 partial sums in f32 (its HLO:
``f32[16,4096,896] all-reduce(%convert_bitcast_fusion)``, a convert
from bf16); in a training step two thirds of that again, since the
reference's remat recomputes each layer's forward all-reduce in the
backward (three of the residual stream a layer: forward, recomputed
forward, backward) and torch's checkpoint stops its recompute at the
last tensor the backward saved, before the layer's closing all-reduce
(two a layer). One all-reduce of the residual stream a layer missing or
extra moves a train row by a half and a prefill row by three quarters,
so ``DRYRUN_COLL_RTOL`` catches it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

# Per-device FLOPs against the reference's: the largest relative
# difference allowed. 48 of the 64 rows are equal; the rest are Zamba2's
# (0.947-0.983: the reference scales the shared attention block's branch
# by 1/6 over 81 layers, 13.5 applications, where the port runs and
# counts the 13 there are) and xLSTM's (1.003-1.061: GSPMD splits some
# of its small products over the head's devices or the idle `data` axis).
DRYRUN_FLOPS_RTOL = 0.10
DRYRUN_COLL_EXPECT = {"train": 1 / 3, "prefill": 1 / 2, "decode": 1 / 2}
DRYRUN_COLL_RTOL = 0.10

# Rows whose ratio is another, by (arch, shape, mesh), each with its
# cause. Where a cause names the reference's CPU compile, the port's
# collective computes the same sum and the reference's extra bytes are
# how XLA's CPU pipeline lays it out: it has no pass that adds partial
# sums before one all-reduce (the reference all-reduces each of a
# product's partial input gradients, a tuple all-reduce), and it gathers
# one operand once for each layout its consumers want.
DRYRUN_COLL_EXPECT_CELLS: Dict[Tuple[str, str, str], float] = {
    # A vocab that does not divide `model` (151655, 122753): the rules
    # shard the embedding on d, the residual stream runs on d shards,
    # and a layer's collectives are those of the reference one for one
    # but three: the reference gathers the MLP's input (recomputed) and
    # its output gradient twice each, once for each layout its consumers
    # want (``all-gather.6`` and ``.9`` of one operand), and all-reduces
    # the gate's and the up-projection's input-gradient partials apart
    # (a tuple of two); the port gathers each once and adds the two
    # partials before one all-reduce. So a layer moves 9 all-reduces and
    # 3 gathers of the residual stream in bf16 against the reference's
    # 10 and 5 in f32, and the logits' all-reduce, 0.3-0.4 of the
    # reference's bytes and done once (no remat), moves half of its
    # (`internvl2-1b` reduces only its 3840 text positions of 4096: the
    # reference reduces before it drops the patches).
    ("internvl2-1b", "train_4k", "single"): 0.4252,
    ("internvl2-1b", "train_4k", "multi"): 0.4258,
    ("minicpm-2b", "train_4k", "single"): 0.4305,
    ("minicpm-2b", "train_4k", "multi"): 0.4332,
    # dbrx: the expert-major slot buffer bf16 (16, 20480, 6144) is
    # gathered three times a layer in both packages (forward, recomputed
    # forward, backward), half the reference's f32 bytes, not a third,
    # and it is 0.57 of the reference's bytes; the residual stream's
    # all-reduces are 3 a layer in bf16 against the reference's 5 in f32
    # (its remat recomputes the forward's, and it all-reduces the k and
    # v projections' input-gradient partials apart, over the 8 devices
    # that hold distinct kv heads, where the port adds them to q's).
    ("dbrx-132b", "train_4k", "single"): 0.4220,
    ("dbrx-132b", "train_4k", "multi"): 0.4247,
    # Zamba2: a Mamba2 layer all-reduces its out-projection's partial
    # sums forward and its input gradient backward, 2 in bf16, against
    # the reference's 5 in f32: its remat recomputes the forward's, and
    # it all-reduces the input-gradient partials of w_z, w_x and w_dt
    # apart (a tuple of three) where the port adds them first; the
    # shared attention block's the same way.
    ("zamba2-7b", "train_4k", "single"): 0.2373,
    ("zamba2-7b", "train_4k", "multi"): 0.2381,
    # xLSTM: its bf16 all-reduces and gathers move half the reference's
    # f32 bytes (the residual stream, the mLSTM's y and v, the sLSTM's
    # input path: 1.434e6 against 2.871e6 at `decode_32k`); the reference
    # also trades v's ones channel by two all-to-alls and the sLSTM's
    # gates by collective-permutes (4.49e5 B), where the port
    # all-to-alls the gates and gathers a head's h (9.8e4 B).
    ("xlstm-350m", "decode_32k", "single"): 0.4616,
    ("xlstm-350m", "decode_32k", "multi"): 0.4616,
    # the same at `prefill_32k`, where the sLSTM's 32768 steps make the
    # gate trades 0.127 of the reference's bytes (its collective-permutes
    # and all-to-alls 3.68e9 B, the port's all-to-alls 4.03e8).
    ("xlstm-350m", "prefill_32k", "single"): 0.4328,
    ("xlstm-350m", "prefill_32k", "multi"): 0.4328,
    # at `long_500k` (batch 1) the reference splits the sLSTM's input
    # product and the mLSTM's y over the idle `data` axis and reduces
    # them there.
    ("xlstm-350m", "long_500k", "multi"): 0.5084,
}

# Host-side counts on one torch release against another's (2.11 on the
# card's host, 2.13 on the CPU-only test host): the layouts are stated,
# so the release must not move them.
DRYRUN_RELEASE_COLL_RTOL = 0.01
DRYRUN_RELEASE_FLOPS_RTOL = 1e-6


def coll_expect(arch: str, shape: str, mesh: str, kind: str) -> float:
    """The expected ratio of a row's collective bytes to the
    reference's: its own, or its kind's ("train", "prefill",
    "decode")."""
    return DRYRUN_COLL_EXPECT_CELLS.get((arch, shape, mesh),
                                        DRYRUN_COLL_EXPECT[kind])


def row_faults(row: Mapping[str, Any], ref: Mapping[str, Any],
               kind: str) -> List[str]:
    """What is wrong with a port row against the reference's row of the
    same cell (both with "flops_per_device" and
    "collective_bytes_per_device"): an empty list if nothing."""
    out = []
    if row.get("status") != "ok":
        return [f"status {row.get('status')}"]
    fr = row["flops_per_device"] / ref["flops_per_device"]
    if abs(fr - 1) > DRYRUN_FLOPS_RTOL:
        out.append(f"FLOPs {fr:.4f} x the reference's")
    cr = row["collective_bytes_per_device"] / ref["collective_bytes_per_device"]
    want = coll_expect(row["arch"], row["shape"], row["mesh"], kind)
    if abs(cr / want - 1) > DRYRUN_COLL_RTOL:
        out.append(f"collective bytes {cr:.4f} x the reference's, "
                   f"{want:.4f} expected")
    return out
