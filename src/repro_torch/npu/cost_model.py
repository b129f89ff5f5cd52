"""Analytic operator cost model for the NPU core.

Maps tensor operators onto (ME cycles, VE cycles, HBM bytes) plus the
tiling metadata the NeuISA compiler needs (how many independent ME
partitions exist, and whether the partition had to cut the reduction
dimension — the Fig. 16 overhead case).

Conventions
-----------
* ``me_cycles`` / ``ve_cycles`` are TOTAL work expressed as cycles on
  ONE engine; executing on ``k`` engines divides the span by ``k``
  (the trailing fill/drain inefficiency is already baked into
  ``me_cycles`` via the block model below).
* Matrix engine model: a ``me_dim x me_dim`` weight-stationary block
  takes ``rows + me_dim`` cycles to stream ``rows`` activations
  (fill + drain). Total cycles = #weight-blocks x (rows + me_dim).
  This reproduces the paper's Fig. 6 behavior: an 8-row pop takes 8
  cycles of VE post-processing per 8x128 vector but ~me_dim cycles of
  ME time, so VEs idle during ME-heavy ops and MXU utilization
  collapses for small-row (decode) matmuls.
* Vector engine model: ``elems / (lanes * ops_per_lane)`` cycles.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from repro_torch.npu.hw_config import DEFAULT_CORE, NPUCoreConfig


@dataclass
class Operator:
    """One tensor operator in a workload trace (paper §III-G schema).

    Units: ``me_cycles`` / ``ve_cycles`` are engine cycles of total
    work on ONE engine (see the module conventions above);
    ``hbm_bytes`` is bytes moved over HBM; ``out_elems`` is output
    elements (not bytes)."""

    name: str
    me_cycles: float = 0.0
    ve_cycles: float = 0.0
    hbm_bytes: float = 0.0
    # tiling metadata (selected by the "compiler")
    n_tiles: int = 1              # independent output partitions for MEs
    reduction_split: bool = False  # K-dim partition -> trailing VE-reduce
    fused_ve: bool = True          # VE work rides in ME uTOps' VE slots
    out_elems: float = 0.0        # output size (reduce cost on K-splits)
    shapes: Tuple[Tuple[int, ...], ...] = ()
    # bytes of ``hbm_bytes`` that are parameter (weight) streaming — a
    # piggybacked iteration that runs this op twice (prefill chunk +
    # decode batch) streams the weights ONCE and dedupes this share
    weight_bytes: float = 0.0

    @property
    def kind(self) -> str:
        if self.me_cycles <= 0 and self.ve_cycles <= 0:
            return "mem"
        if self.me_cycles <= 0:
            return "ve"
        return "me"

    def scaled(self, factor: float) -> "Operator":
        """Copy with cycle/byte costs multiplied by ``factor`` (tiling
        metadata unchanged) — scaling by k is profile-equivalent to
        repeating the op k times."""
        return Operator(
            self.name,
            me_cycles=self.me_cycles * factor,
            ve_cycles=self.ve_cycles * factor,
            hbm_bytes=self.hbm_bytes * factor,
            n_tiles=self.n_tiles,
            reduction_split=self.reduction_split,
            fused_ve=self.fused_ve,
            out_elems=self.out_elems,
            shapes=self.shapes,
            weight_bytes=self.weight_bytes * factor,
        )

    def without_weight_stream(self) -> "Operator":
        """Copy with the parameter-streaming HBM share removed — the
        weights were already streamed by an identical op earlier in
        the same fused program (piggybacked iterations count shared
        weight reads once)."""
        if self.weight_bytes <= 0:
            return self
        return Operator(
            self.name,
            me_cycles=self.me_cycles,
            ve_cycles=self.ve_cycles,
            hbm_bytes=max(self.hbm_bytes - self.weight_bytes, 0.0),
            n_tiles=self.n_tiles,
            reduction_split=self.reduction_split,
            fused_ve=self.fused_ve,
            out_elems=self.out_elems,
            shapes=self.shapes,
            weight_bytes=0.0,
        )


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def matmul_op(
    name: str,
    m: int,
    k: int,
    n: int,
    core: NPUCoreConfig = DEFAULT_CORE,
    dtype_bytes: int = 2,
    ve_post_elems: float = 0.0,
    weight_resident: bool = False,
    act_in_sram: bool = True,
    out_to_hbm: bool = False,
) -> Operator:
    """(m,k) @ (k,n) on the systolic MEs.

    ``ve_post_elems``: extra per-output VE work fused into the op
    (bias/activation/residual), in elements; defaults to a pop-side
    aggregation of 1 op per output element (the VE must always drain
    the systolic array — paper Fig. 6).
    """
    md = core.me_dim
    blocks = _ceil_div(k, md) * _ceil_div(n, md)
    # Per weight-stationary block: stream `m` activation rows through
    # the array; the next block's weights load in the shadow (double
    # buffered) at HBM rate (or SRAM rate when the operand is
    # resident). Small-row (decode) matmuls thus become weight-stream
    # paced — the paper's §V-F "memory-bound, MEs underutilized" case.
    w_stream = (md * md * dtype_bytes) / core.hbm_bytes_per_cycle
    if weight_resident:
        w_stream = 8.0  # SRAM-resident operand: near-free reload
    me_cycles = blocks * max(float(m), w_stream) + md
    # VE drains every output vector + any fused epilogue
    ve_elems = m * n + ve_post_elems
    ve_cycles = ve_elems / core.ve_elems_per_cycle

    hbm = 0.0
    w_bytes = 0.0
    if not weight_resident:
        w_bytes = k * n * dtype_bytes       # stream weights once
        hbm += w_bytes
    if not act_in_sram:
        hbm += m * k * dtype_bytes
    if out_to_hbm:
        hbm += m * n * dtype_bytes

    # tiling: prefer output partitions. A partition must amortize the
    # array fill/drain, so the compiler's tile floor is 128 rows x 256
    # cols (the same floor as the Pallas kernels' BlockSpecs) — small
    # operators therefore CANNOT fill every ME, which is exactly the
    # paper's Fig. 9 false-contention case for VLIW baselines.
    out_tiles = _ceil_div(m, md) * _ceil_div(n, 2 * md)
    reduction_split = False
    n_tiles = out_tiles
    if out_tiles < core.n_me and _ceil_div(k, md) >= 2:
        n_tiles = min(core.n_me, _ceil_div(k, md))
        reduction_split = True
    return Operator(
        name,
        me_cycles=float(me_cycles),
        ve_cycles=float(ve_cycles),
        hbm_bytes=float(hbm),
        n_tiles=max(int(n_tiles), 1),
        reduction_split=reduction_split,
        out_elems=float(m * n),
        shapes=((m, k), (k, n)),
        weight_bytes=float(w_bytes),
    )


def vector_op(
    name: str,
    elems: float,
    core: NPUCoreConfig = DEFAULT_CORE,
    flops_per_elem: float = 1.0,
    hbm_bytes: float = 0.0,
) -> Operator:
    """Pure VE operator (softmax, norm, activation, rope, scan step...)."""
    cycles = elems * flops_per_elem / core.ve_elems_per_cycle
    return Operator(
        name,
        ve_cycles=float(cycles),
        hbm_bytes=float(hbm_bytes),
        n_tiles=1,
        shapes=((int(elems),),),
    )


def memory_op(
    name: str,
    hbm_bytes: float,
    core: NPUCoreConfig = DEFAULT_CORE,
    ve_elems: float = 0.0,
) -> Operator:
    """HBM-dominated operator (embedding gather, KV-cache read...).

    The VEs issue the gathers/DMA descriptors, so their active time is
    paced by HBM bandwidth — this is what makes DLRM/NCF "VE-intensive"
    in the paper's Fig. 4/5 even though they do little arithmetic.
    """
    issue_cycles = ve_elems / core.ve_elems_per_cycle if ve_elems else 0.0
    ve_cycles = max(issue_cycles, hbm_bytes / core.hbm_bytes_per_cycle)
    return Operator(
        name,
        ve_cycles=float(ve_cycles),
        hbm_bytes=float(hbm_bytes),
        n_tiles=1,
    )


# ----------------------------------------------------------------------
@dataclass
class WorkloadTrace:
    """A sequence of dependent operators = one inference request.

    Matches the paper's replayed trace: DNN inference graphs are
    (post-fusion) a dependency chain of operators; intra-operator
    parallelism is expressed through ``n_tiles``.
    """

    name: str
    ops: List[Operator] = field(default_factory=list)
    hbm_footprint: float = 0.0   # resident bytes (weights + cache)
    core: NPUCoreConfig = DEFAULT_CORE

    def extend(self, ops: List[Operator]) -> None:
        self.ops.extend(ops)

    # -- §III-B profile: run on 1 ME + 1 VE, ME/VE pipelined per op --
    def profile_mv(self) -> Tuple[float, float]:
        """Returns (m, v): ME / VE active-time fractions on a 1ME+1VE
        core (compile-time profile the vNPU allocator consumes)."""
        t_total = me_t = ve_t = 0.0
        for op in self.ops:
            span = max(op.me_cycles, op.ve_cycles, 1e-9)
            t_total += span
            me_t += op.me_cycles
            ve_t += op.ve_cycles
        if t_total <= 0:
            return 0.0, 0.0
        return me_t / t_total, ve_t / t_total

    def totals(self) -> Tuple[float, float, float]:
        """(ME cycles, VE cycles, HBM bytes) summed over the trace."""
        return (
            sum(o.me_cycles for o in self.ops),
            sum(o.ve_cycles for o in self.ops),
            sum(o.hbm_bytes for o in self.ops),
        )

    def ideal_cycles(self, n_me: int, n_ve: int) -> float:
        """Lower bound in cycles: perfectly parallel + overlapped
        execution on ``n_me`` MEs / ``n_ve`` VEs."""
        me, ve, hbm = self.totals()
        return max(me / n_me, ve / n_ve, hbm / self.core.hbm_bytes_per_cycle)


# ----------------------------------------------------------------------
# phase-structured request IR
# ----------------------------------------------------------------------
def decode_bucket(context: int, base: int = 512) -> int:
    """Context bucket a decode step at ``context`` falls into: the
    smallest ``base * 2**k`` >= context. Decode cost (KV stream, score
    matmul K-dim) is bucketed so the compiler emits one program per
    bucket instead of one per context length."""
    b = base
    while b < context:
        b <<= 1
    return b


def batch_bucket(n: int) -> int:
    """Decode-batch bucket for piggybacked programs: the smallest
    power of two >= ``n`` (0 for an empty batch). Piggyback program
    cache keys use the bucket instead of the live batch so the cache
    stays bounded; cost is taken at the bucket ceiling (conservative,
    same idiom as :func:`decode_bucket`)."""
    if n <= 0:
        return 0
    return 1 << (int(n) - 1).bit_length()


# tokens a budgeted prefill slice never shrinks below (prefill must
# always progress — SARATHI-SF's "stall-free" floor), and the grids
# the piggyback program cache quantizes on: slice token counts round
# up to PIGGYBACK_TOKEN_QUANT and the chunk's prior-context position
# rounds up to PIGGYBACK_POS_QUANT, so the cache holds O(log) programs
# per (shape, budget) instead of one per live (slice, position) pair.
PIGGYBACK_CHUNK_FLOOR = 32
PIGGYBACK_TOKEN_QUANT = 32
PIGGYBACK_POS_QUANT = 64


@dataclass
class RequestPlan:
    """Phase-structured request IR: one generation request = a prefill
    phase (prompt ingestion, emits the first token) followed by up to
    ``gen_len - 1`` decode steps against a growing KV cache.

    Decode cost is *context-bucketed*: ``decode`` holds one
    (bucket_context, trace) pair per power-of-two bucket covering
    ``prompt_len + 1 .. prompt_len + max_gen``; a decode step at
    context c uses the smallest bucket >= c. A single-phase workload
    (the seed's fixed-phase traces) is the degenerate plan with
    ``gen_len <= 1`` and no decode entries.

    Prefill may additionally be *chunked* (SARATHI-style): when
    ``prefill_chunk_tokens > 0`` and the prompt is longer than one
    chunk, ``prefill_chunks`` holds one partial-context trace per
    chunk of the prompt. Each chunk ingests up to
    ``prefill_chunk_tokens`` prompt tokens against the KV written by
    the chunks before it; only the final chunk emits the first token.
    The simulator treats each chunk as its own phase, so a tenant's
    in-flight decode iterations interleave *between* its prefill
    chunks instead of head-of-line blocking behind the whole prompt.
    With the knob unset (0), ``prefill_chunks`` is empty and the plan
    is bit-identical to the monolithic-prefill IR.

    A further refinement replaces the *static* chunk knob entirely:
    ``iteration_token_budget`` > 0 enables SARATHI-SF-style
    **piggybacked iterations** — the simulator sizes each prefill
    slice adaptively (budget minus the live decode batch, floored so
    prefill always progresses) and runs the slice and the tenant's
    live decode tokens as ONE fused program. Those mixed programs are
    built on demand through ``piggyback_builder`` (a callable
    ``(chunk_tokens, kv_prior, decode_batch, decode_ctx, final) ->
    WorkloadTrace``); the trace layer attaches it for generative
    plans. With the budget unset (0) the builder is never invoked and
    every path is bit-identical to the static-chunk / monolithic IR.

    Per-phase KV-cache accounting: ``kv_token_bytes`` is the HBM bytes
    the KV cache grows by for every token the request ingests or
    generates, at the REAL (unbucketed) context — the prefill phase
    writes ``kv_prompt_bytes`` (= ``prompt_len`` tokens; a chunk or
    piggybacked slice writes only its own tokens' share), and each
    decode step grows the cache by one token. The live-ledger
    simulator charges these against the tenant's
    :class:`~repro_torch.core.vnpu.KVLedger` at phase boundaries; with
    ``kv_token_bytes == 0`` (non-attention families, or single-phase
    plans) the ledger path is inert and ``hbm_footprint`` stays the
    static admission-time max it always was. ``weight_bytes`` is the
    resident parameter share the ledger reserves up front.
    ``swapin_builder`` makes the HBM re-read trace an evicted
    request's KV restore pays on resume (one
    :func:`memory_op` over the context's KV bytes, built per decode
    bucket). ``prefix_len`` marks the leading prompt tokens that may be
    shared across requests (refcounted in the ledger); on a prefix hit
    the simulator runs the suffix-only trace from ``prefix_builder``
    (``cached_tokens -> WorkloadTrace``) and charges only the unshared
    suffix bytes. With ``prefix_len == 0`` the path is inert.

    Units: trace costs are engine cycles / HBM bytes (see
    :class:`Operator`); ``prompt_len`` / ``gen_len`` / ``max_gen`` /
    ``prefill_chunk_tokens`` / ``iteration_token_budget`` are token
    counts; ``hbm_footprint`` / ``kv_token_bytes`` / ``weight_bytes``
    are bytes.
    """

    name: str
    prefill: WorkloadTrace
    decode: List[Tuple[int, WorkloadTrace]] = field(default_factory=list)
    prompt_len: int = 0
    gen_len: int = 1             # default generated tokens per request
    max_gen: int = 0             # bucket coverage (>= any sampled gen len)
    bucket_base: int = 512
    hbm_footprint: float = 0.0
    # SARATHI-style chunked prefill: tokens per chunk (0 = monolithic)
    prefill_chunk_tokens: int = 0
    prefill_chunks: List[WorkloadTrace] = field(default_factory=list)
    # adaptive piggybacked iterations: target tokens per iteration
    # (0 = off); the builder makes mixed chunk+decode traces on demand
    iteration_token_budget: int = 0
    piggyback_builder: Optional[Callable[..., WorkloadTrace]] = \
        field(default=None, repr=False, compare=False)
    # live KV-cache accounting (0 = ledger path inert)
    kv_token_bytes: float = 0.0  # KV bytes written per ingested/generated
                                 # token (real context, unbucketed)
    weight_bytes: float = 0.0    # resident parameter bytes (ledger reserve)
    swapin_builder: Optional[Callable[[int], WorkloadTrace]] = \
        field(default=None, repr=False, compare=False)
    # cross-request shared KV prefix: leading tokens that may already be
    # resident in a refcounted shared ledger entry (0 = no sharing); the
    # builder makes the suffix-only prefill trace for a given cached
    # prefix length
    prefix_len: int = 0
    prefix_builder: Optional[Callable[[int], WorkloadTrace]] = \
        field(default=None, repr=False, compare=False)

    def __post_init__(self) -> None:
        self.decode = sorted(self.decode, key=lambda p: p[0])
        if not self.max_gen:
            self.max_gen = self.gen_len
        if not self.hbm_footprint:
            traces = ([self.prefill] + list(self.prefill_chunks)
                      + [t for _, t in self.decode])
            self.hbm_footprint = max(t.hbm_footprint for t in traces)

    @property
    def has_decode(self) -> bool:
        """True when the plan carries context-bucketed decode phases."""
        return bool(self.decode)

    @property
    def kv_prompt_bytes(self) -> float:
        """KV bytes the (whole) prefill phase writes: the prompt's
        cache at the real context. Chunked/budgeted prefill charges
        this incrementally, one chunk/slice's tokens at a time."""
        return self.prompt_len * self.kv_token_bytes

    @property
    def chunked(self) -> bool:
        """True when prefill runs as a chain of chunk phases."""
        return bool(self.prefill_chunks)

    @property
    def piggybacked(self) -> bool:
        """True when iterations are budgeted: prefill slices size
        adaptively and carry the live decode batch in one program."""
        return self.iteration_token_budget > 0

    @property
    def n_prefill_chunks(self) -> int:
        """Prefill phases per request (1 when monolithic)."""
        return len(self.prefill_chunks) or 1

    def prefill_phases(self) -> List[WorkloadTrace]:
        """The prefill phase chain: the chunk traces in ingestion
        order, or the single monolithic trace."""
        return list(self.prefill_chunks) or [self.prefill]

    def decode_trace_for(self, context: int) -> Tuple[int, WorkloadTrace]:
        """(bucket, trace) for a decode step at ``context``; clamps to
        the largest precompiled bucket for out-of-coverage requests."""
        if not self.decode:
            raise ValueError(f"plan {self.name!r} has no decode phases")
        for ctx, tr in self.decode:
            if context <= ctx:
                return ctx, tr
        return self.decode[-1]

    def decode_steps(self, gen_len: Optional[int] = None) -> int:
        """Decode iterations a request needs: the prefill emits token 1,
        each decode step one more."""
        n = self.gen_len if gen_len is None else gen_len
        return max(n - 1, 0)

    def profile_trace(self) -> WorkloadTrace:
        """Flatten into one WorkloadTrace weighted by the default
        generation length — feeds the compile-time (m, v) profile the
        Eq. 1-4 allocator consumes, so a decode-heavy tenant's vNPU
        split reflects its decode:prefill cycle mix. A chunked plan
        blends the chunk traces (which carry the real per-chunk KV
        re-read and fill/drain overhead) instead of the monolithic
        prefill, so the allocator sees the cost of what will actually
        execute."""
        tr = WorkloadTrace(name=f"{self.name}:profile",
                           core=self.prefill.core)
        for ptr in self.prefill_phases():
            tr.ops.extend(ptr.ops)
        steps = self.decode_steps()
        if steps and self.decode:
            # distribute the default request's steps over its buckets;
            # scaling an op by k is profile-equivalent to repeating it
            per_bucket = self._steps_per_bucket(steps)
            for (_, dtr), n in zip(self.decode, per_bucket):
                if n <= 0:
                    continue
                tr.ops.extend(op.scaled(float(n)) for op in dtr.ops)
        tr.hbm_footprint = self.hbm_footprint
        return tr

    def _steps_per_bucket(self, steps: int) -> List[int]:
        out = []
        done = 0
        for ctx, _ in self.decode:
            # steps whose context (prompt + tokens emitted so far + 1)
            # fits under this bucket's ceiling
            hi = min(ctx - self.prompt_len - 1, steps)
            n = max(hi - done, 0)
            out.append(n)
            done += n
        if out and done < steps:
            out[-1] += steps - done  # clamp tail to the largest bucket
        return out
