"""Workload trace generation: ModelConfig -> operator trace.

Replaces the paper's real-TPU profiling (§III-G): for each assigned
architecture we emit the per-operator (ME cycles, VE cycles, HBM
bytes, tiling) sequence of one inference request (prefill or decode)
or one training step. The op inventory mirrors what XLA emits for
these models post-fusion: projection matmuls with fused epilogues,
attention score/context matmuls, softmax/norm/rope vector ops,
embedding gathers, MoE routing + expert GEMMs, SSD chunk scans.

Approximations are documented inline; the simulator consumes only the
(me, ve, hbm, tiling) schema, exactly like the paper's replayed
traces.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.npu.cost_model import (
    Operator,
    RequestPlan,
    WorkloadTrace,
    decode_bucket,
    matmul_op,
    memory_op,
    vector_op,
)
from repro_torch.npu.hw_config import DEFAULT_CORE, NPUCoreConfig

DTYPE = 2  # bf16


# ----------------------------------------------------------------------
# per-block builders. T = tokens processed this call.
# ----------------------------------------------------------------------
def _attention_ops(
    cfg: ModelConfig, B: int, S: int, T: int, phase: str, core: NPUCoreConfig,
    kv_prior: int = 0,
) -> List[Operator]:
    """Attention block ops. ``kv_prior`` > 0 makes a prefill call a
    *chunk*: the S new tokens attend to ``kv_prior`` already-ingested
    keys (streamed back from HBM) plus themselves. ``kv_prior == 0``
    is the monolithic prefill and emits bit-identical operators to the
    pre-chunking builder (the causal 0.5 factor is the kv_prior=0 case
    of the general chunk fraction)."""
    d, dq, dkv, hd = cfg.d_model, cfg.d_q, cfg.d_kv, cfg.d_head
    H = cfg.n_heads
    ops: List[Operator] = [
        vector_op("rmsnorm", T * d, core, flops_per_elem=4.0),
        matmul_op(
            "qkv_proj", T, d, dq + 2 * dkv, core,
            ve_post_elems=(T * (dq + 2 * dkv)) if cfg.qkv_bias else 0.0,
        ),
        vector_op("rope", T * (dq + dkv), core, flops_per_elem=3.0),
    ]
    if cfg.qk_norm:
        ops.append(vector_op("qk_norm", T * (dq + dkv), core, flops_per_elem=4.0))
    if phase == "prefill":
        # scores: (B*H*S, hd) @ (hd, K) over K = prior + new keys;
        # causal masking keeps frac of the score matrix (exactly 0.5
        # for a monolithic prefill, approaching 1.0 for a late chunk
        # whose rows attend to nearly the whole context)
        K = kv_prior + S
        frac = (kv_prior + 0.5 * S) / K
        ops.append(
            matmul_op("attn_scores", B * H * S, hd, K, core).scaled(frac)
        )
        ops.append(vector_op("softmax", frac * B * H * S * K, core, flops_per_elem=5.0))
        ops.append(matmul_op("attn_ctx", B * H * S, K, hd, core).scaled(frac))
        if kv_prior:
            # chunked prefill re-reads the earlier chunks' KV from HBM
            # — the per-chunk overhead that bounds how small a chunk
            # is worth making
            ops.append(
                memory_op(
                    "kv_chunk_read",
                    2.0 * B * cfg.n_kv_heads * kv_prior * hd * DTYPE, core)
            )
    else:
        # decode: stream the KV cache from HBM; MXU sees tiny row counts
        kv_bytes = 2.0 * B * cfg.n_kv_heads * S * hd * DTYPE
        qk = matmul_op("attn_scores_dec", B * H, hd, S, core, weight_resident=True)
        ctx = matmul_op("attn_ctx_dec", B * H, S, hd, core, weight_resident=True)
        ops.append(
            Operator(
                "attn_decode",
                me_cycles=qk.me_cycles + ctx.me_cycles,
                ve_cycles=(B * H * S * 6.0) / core.ve_elems_per_cycle,
                hbm_bytes=kv_bytes,
                n_tiles=min(core.n_me, max(B * H // 8, 1)),
            )
        )
    ops.append(matmul_op("o_proj", T, dq, d, core, ve_post_elems=T * d))
    return ops


def _dense_mlp_ops(
    cfg: ModelConfig, T: int, core: NPUCoreConfig, d_ff: int = 0, tag: str = "mlp"
) -> List[Operator]:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    ops = [vector_op(f"{tag}_norm", T * d, core, flops_per_elem=4.0)]
    if cfg.mlp_gated:
        ops.append(matmul_op(f"{tag}_gate_up", T, d, 2 * ff, core))
        ops.append(vector_op(f"{tag}_silu_mul", T * ff, core, flops_per_elem=4.0))
    else:
        # GELU epilogue ~6 VE ops/element
        ops.append(matmul_op(f"{tag}_up", T, d, ff, core,
                             ve_post_elems=T * ff * 6.0))
    ops.append(matmul_op(f"{tag}_down", T, ff, d, core, ve_post_elems=T * d))
    return ops


def _moe_ops(cfg: ModelConfig, T: int, core: NPUCoreConfig) -> List[Operator]:
    d, E, k = cfg.d_model, cfg.n_experts, cfg.n_experts_per_tok
    d_e = cfg.d_expert or cfg.d_ff
    ops = [
        vector_op("moe_norm", T * d, core, flops_per_elem=4.0),
        matmul_op("router", T, d, E, core),
        vector_op("topk_softmax", T * E, core, flops_per_elem=6.0),
        # dispatch gather/scatter is VE + HBM traffic
        vector_op("dispatch", T * k * d, core, flops_per_elem=2.0),
    ]
    # expert GEMMs: T*k token-slots across experts; expert weights
    # streamed for every *activated* expert.
    import math

    activated = E * (1.0 - (1.0 - min(k / E, 1.0)) ** max(T, 1))
    n_act = min(E, max(int(math.ceil(activated)), k))
    w_bytes = n_act * 3 * d * d_e * DTYPE
    gu = matmul_op("experts_gate_up", T * k, d, 2 * d_e, core, weight_resident=True)
    dn = matmul_op("experts_down", T * k, d_e, d, core, weight_resident=True)
    ops.append(
        Operator(
            "experts_gate_up",
            me_cycles=gu.me_cycles,
            ve_cycles=gu.ve_cycles + (T * k * d_e * 4.0) / core.ve_elems_per_cycle,
            hbm_bytes=w_bytes * (2.0 / 3.0),
            n_tiles=min(core.n_me, max(n_act, 1)),
            weight_bytes=w_bytes * (2.0 / 3.0),
        )
    )
    ops.append(
        Operator(
            "experts_down",
            me_cycles=dn.me_cycles,
            ve_cycles=dn.ve_cycles,
            hbm_bytes=w_bytes / 3.0,
            n_tiles=min(core.n_me, max(n_act, 1)),
            weight_bytes=w_bytes / 3.0,
        )
    )
    ops.append(vector_op("combine", T * k * d * 2.0, core))
    if cfg.n_shared_experts:
        ops.extend(
            _dense_mlp_ops(
                cfg, T, core, d_ff=cfg.n_shared_experts * d_e, tag="shared_exp"
            )[1:]  # skip the extra norm
        )
    return ops


def _mamba2_ops(
    cfg: ModelConfig, B: int, S: int, T: int, phase: str, core: NPUCoreConfig
) -> List[Operator]:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    nh = cfg.ssm_heads or max(d_in // max(cfg.ssm_head_dim, 1), 1)
    hd = cfg.ssm_head_dim or d_in // nh
    st = cfg.ssm_state
    C = cfg.ssm_chunk
    d_proj = 2 * d_in + 2 * st + nh
    ops = [
        vector_op("ssm_norm", T * d, core, flops_per_elem=4.0),
        matmul_op("ssm_in_proj", T, d, d_proj, core),
        vector_op("ssm_conv1d", T * (d_in + 2 * st) * cfg.ssm_conv, core),
    ]
    if phase == "prefill":
        # SSD chunked form: intra-chunk "attention" (CxC per head) +
        # chunk-state matmuls (hd x st) + inter-chunk scan combine.
        intra = matmul_op("ssd_intra", T * nh, hd, C, core).scaled(0.5)
        state = matmul_op("ssd_state", T * nh, hd, st, core)
        ops.append(intra)
        ops.append(state)
        n_chunks = max(T // C, 1)
        ops.append(
            vector_op("ssd_scan", n_chunks * nh * hd * st, core, flops_per_elem=6.0)
        )
    else:
        # recurrent decode: h = a*h + dBx ; y = C.h  — pure VE + state I/O
        state_elems = B * nh * hd * st
        ops.append(
            vector_op(
                "ssd_step", state_elems, core, flops_per_elem=6.0,
                hbm_bytes=2.0 * state_elems * DTYPE,
            )
        )
    ops.append(vector_op("ssm_gate_norm", T * d_in, core, flops_per_elem=5.0))
    ops.append(matmul_op("ssm_out_proj", T, d_in, d, core, ve_post_elems=T * d))
    return ops


def _xlstm_ops(
    cfg: ModelConfig, kind: str, B: int, S: int, T: int, phase: str,
    core: NPUCoreConfig,
) -> List[Operator]:
    d = cfg.d_model
    up = int(cfg.xlstm_proj_factor * d)
    H = cfg.n_heads
    hd = up // H
    ops = [
        vector_op(f"{kind}lstm_norm", T * d, core, flops_per_elem=4.0),
        matmul_op(f"{kind}lstm_up", T, d, 2 * up, core),
    ]
    if kind == "m":
        ops.append(matmul_op("mlstm_qkv", T, up, 3 * up, core))
        if phase == "prefill":
            C = min(256, S)
            ops.append(matmul_op("mlstm_intra", T * H, hd, C, core).scaled(0.5))
            ops.append(matmul_op("mlstm_state", T * H, hd, hd, core).scaled(1.0 / C))
            ops.append(vector_op("mlstm_gates", T * up * 6.0, core))
        else:
            # matrix memory update: per-head hd x hd outer-product + read
            state_elems = B * H * hd * hd
            ops.append(
                vector_op(
                    "mlstm_step", state_elems, core, flops_per_elem=4.0,
                    hbm_bytes=2.0 * state_elems * DTYPE,
                )
            )
    else:  # sLSTM: block-diag recurrent matvecs — VE-bound by design
        ops.append(
            vector_op(
                f"slstm_recurrence", T * up * (hd + 8.0), core,
                hbm_bytes=(B * up * DTYPE * 2.0 if phase == "decode" else 0.0),
            )
        )
    ops.append(vector_op(f"{kind}lstm_gate", T * up * 3.0, core))
    ops.append(matmul_op(f"{kind}lstm_down", T, up, d, core, ve_post_elems=T * d))
    return ops


# ----------------------------------------------------------------------
def lm_trace(
    cfg: ModelConfig,
    batch: int,
    seq: int,
    phase: str = "prefill",
    core: NPUCoreConfig = DEFAULT_CORE,
    include_head: bool = True,
    kv_prior: int = 0,
) -> WorkloadTrace:
    """Operator trace of ONE forward pass (one request batch).

    phase: "prefill" (T = batch*seq tokens) | "decode" (T = batch
    tokens against a cache of length `seq`).

    ``kv_prior`` (prefill only): tokens of context already ingested by
    earlier prefill *chunks* — the new ``seq`` tokens attend to the
    prior KV (streamed from HBM) plus themselves, turning this trace
    into one SARATHI-style prefill chunk. SSM/recurrent families carry
    their state in SRAM between chunks, so only attention layers see a
    kv_prior cost. ``kv_prior=0`` (the default) is the monolithic
    prefill, bit-identical to the pre-chunking trace.
    """
    assert phase in ("prefill", "decode"), phase
    assert kv_prior == 0 or phase == "prefill", "kv_prior is prefill-only"
    B, S = batch, seq
    T = B * S if phase == "prefill" else B
    name = (f"{cfg.name}:{phase}:b{B}s{S}" if not kv_prior
            else f"{cfg.name}:{phase}:b{B}k{kv_prior}+{S}")
    tr = WorkloadTrace(name=name, core=core)

    d = cfg.d_model
    n_streams = max(cfg.n_codebooks, 1)
    tr.ops.append(
        memory_op("embed", hbm_bytes=float(T * n_streams * d * DTYPE),
                  core=core, ve_elems=T * d * n_streams)
    )
    if cfg.frontend == "vit_stub" and phase == "prefill" and not kv_prior:
        # vision patches ride in the first chunk only
        tr.ops.append(
            memory_op("patch_embeds", hbm_bytes=float(B * cfg.n_patches * d * DTYPE),
                      core=core)
        )

    for layer in range(cfg.n_layers):
        if cfg.family in ("dense", "moe", "vlm", "audio"):
            tr.extend(_attention_ops(cfg, B, S, T, phase, core, kv_prior))
            if cfg.family == "moe":
                tr.extend(_moe_ops(cfg, T, core))
            else:
                tr.extend(_dense_mlp_ops(cfg, T, core))
        elif cfg.family == "ssm" and cfg.xlstm_pattern:
            kind = cfg.xlstm_pattern[layer % len(cfg.xlstm_pattern)]
            tr.extend(_xlstm_ops(cfg, kind, B, S, T, phase, core))
        elif cfg.family in ("ssm", "hybrid"):
            tr.extend(_mamba2_ops(cfg, B, S, T, phase, core))
            if (
                cfg.family == "hybrid"
                and cfg.hybrid_attn_every
                and (layer + 1) % cfg.hybrid_attn_every == 0
            ):
                tr.extend(_attention_ops(cfg, B, S, T, phase, core, kv_prior))
                tr.extend(_dense_mlp_ops(cfg, T, core))
        else:  # pragma: no cover
            raise ValueError(f"unknown family {cfg.family}")

    tr.ops.append(vector_op("final_norm", T * d, core, flops_per_elem=4.0))
    if include_head:
        # decode emits logits for T tokens; prefill typically also does
        # (training/scoring) — matches XLA traces.
        tr.ops.append(
            matmul_op("lm_head", T, d, cfg.vocab_size * n_streams, core)
        )

    # resident footprint: weights + KV/state cache (a chunk's cache
    # covers the full context ingested so far, not just its tokens)
    ctx = kv_prior + S
    kv = 0.0
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        kv = 2.0 * B * cfg.n_kv_heads * cfg.d_head * ctx * cfg.n_layers * DTYPE
    elif cfg.family == "hybrid":
        n_attn = cfg.n_layers // max(cfg.hybrid_attn_every, 1)
        kv = 2.0 * B * cfg.n_kv_heads * cfg.d_head * ctx * n_attn * DTYPE
        kv += B * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * cfg.n_layers * DTYPE
    tr.hbm_footprint = cfg.param_count() * DTYPE + kv
    return tr


def kv_bytes_per_token(cfg: ModelConfig, batch: int = 1) -> float:
    """HBM bytes the KV cache grows by per ingested/generated token
    (the K and V rows every attention layer writes). Matches the
    per-context cache term in :func:`lm_trace`'s footprint; SSM /
    recurrent families carry fixed-size state instead of a growing
    cache, so they return 0 and the live KV ledger stays inert."""
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        n_attn = cfg.n_layers
    elif cfg.family == "hybrid":
        n_attn = cfg.n_layers // max(cfg.hybrid_attn_every, 1)
    else:
        return 0.0
    return 2.0 * batch * cfg.n_kv_heads * cfg.d_head * n_attn * DTYPE


def kv_swapin_trace(
    cfg: ModelConfig,
    batch: int,
    context: int,
    core: NPUCoreConfig = DEFAULT_CORE,
) -> WorkloadTrace:
    """HBM re-read an evicted request pays to restore its swapped-out
    KV cache before rejoining decode: one memory operator streaming
    the cache at ``context`` tokens back into the tenant's segments
    (no compute — the paper's §III-B tensor-swapping cost, applied to
    per-request KV instead of weights)."""
    bytes_ = kv_bytes_per_token(cfg, batch) * context
    tr = WorkloadTrace(name=f"{cfg.name}:swapin:b{batch}@{context}",
                       core=core)
    tr.ops.append(memory_op("kv_swapin", float(bytes_), core))
    return tr


def kv_prefix_trace(
    cfg: ModelConfig,
    batch: int,
    prompt_len: int,
    cached_tokens: int,
    core: NPUCoreConfig = DEFAULT_CORE,
    include_head: bool = True,
) -> WorkloadTrace:
    """Prefix-aware prefill: the first ``cached_tokens`` of the prompt
    are already resident in a SHARED KV entry (cross-request prefix
    cache hit), so only the unshared suffix is ingested. The suffix
    still attends causally over the cached prefix — identical cost
    structure to a SARATHI chunk at prior context ``cached_tokens``
    (causal-fraction attention + the per-chunk KV re-read streaming
    the cached prefix), so a hit pays exactly what a chunked prefill
    resuming at that position would, never less.

    ``cached_tokens`` is clamped to ``prompt_len - 1``: even a fully
    cached prompt runs a 1-token pass to emit the first token."""
    cached = max(min(int(cached_tokens), prompt_len - 1), 0)
    suffix = prompt_len - cached
    tr = lm_trace(cfg, batch, suffix, "prefill", core,
                  include_head=include_head, kv_prior=cached)
    tr.name = f"{cfg.name}:prefix:b{batch}c{cached}+{suffix}"
    return tr


def piggyback_trace(
    cfg: ModelConfig,
    batch: int,
    chunk_tokens: int,
    kv_prior: int,
    decode_batch: int,
    decode_ctx: int,
    core: NPUCoreConfig = DEFAULT_CORE,
    include_head: bool = True,
    final: bool = True,
    decode_groups: Optional[Sequence[Tuple[int, int]]] = None,
) -> WorkloadTrace:
    """One SARATHI-SF *piggybacked iteration*: a prefill chunk of
    ``chunk_tokens`` prompt tokens at prior context ``kv_prior`` fused
    with ``decode_batch`` live decode tokens at context bucket
    ``decode_ctx`` — a single program, so a decoding request's token
    cadence no longer waits out a whole chunk iteration.

    Costing (the paper's fine-grained operator mixing, §V-F):

    * the chunk slice keeps causal-fraction attention over
      ``kv_prior + chunk_tokens`` keys plus the per-chunk KV re-read
      (identical ops to :func:`lm_trace` with ``kv_prior``);
    * each decode token pays its per-token attention against the KV
      stream at ITS OWN context bucket: ``decode_groups`` is a
      sequence of ``(batch, ctx_bucket)`` pairs — one decode
      sub-trace per bucket with live riders, so a small-context rider
      no longer pays the largest live bucket's KV stream. The legacy
      ``(decode_batch, decode_ctx)`` pair is the single-group case
      (kept as the calling convention when every rider shares one
      bucket, so those programs — and their cache keys — are
      byte-identical to the pre-grouping builder);
    * **shared weight reads are counted once**: every decode operator
      whose weights were already streamed by a same-named operator
      earlier in the fused program (the chunk, or a previous decode
      group) drops its :attr:`Operator.weight_bytes` HBM share
      (KV-cache / state / embedding traffic is per-token and stays).

    ``final`` marks the slice that completes the prompt — only then
    does the chunk side carry the lm_head that emits the first token
    (mirroring the static-chunk rule). An empty decode side degrades
    to a plain chunk trace. Units: all token counts; context values
    are bucket ceilings in tokens.
    """
    chunk = lm_trace(cfg, batch, chunk_tokens, "prefill", core,
                     include_head=include_head and final,
                     kv_prior=kv_prior)
    if decode_groups is not None:
        groups = [(b, c) for b, c in decode_groups if b > 0]
    else:
        groups = [(decode_batch, decode_ctx)] if decode_batch > 0 else []
    if not groups:
        return chunk
    groups.sort(key=lambda g: g[1])
    tag = "".join(f"+d{b}@{c}" for b, c in groups)
    tr = WorkloadTrace(
        name=(f"{cfg.name}:piggy:b{batch}k{kv_prior}+{chunk_tokens}"
              f"{'f' if final else ''}{tag}"),
        core=core)
    tr.ops.extend(chunk.ops)
    tr.hbm_footprint = chunk.hbm_footprint
    streamed = {op.name for op in chunk.ops if op.weight_bytes > 0}
    for db, ctx in groups:
        dec = lm_trace(cfg, batch * db, ctx, "decode", core,
                       include_head=include_head)
        tr.ops.extend(op.without_weight_stream() if op.name in streamed
                      else op for op in dec.ops)
        streamed.update(op.name for op in dec.ops if op.weight_bytes > 0)
        tr.hbm_footprint = max(tr.hbm_footprint, dec.hbm_footprint)
    return tr


def request_plan(
    cfg: ModelConfig,
    batch: int,
    prompt_len: int,
    gen_len: int,
    core: NPUCoreConfig = DEFAULT_CORE,
    max_gen: int = 0,
    bucket: int = 512,
    include_head: bool = True,
    prefill_chunk_tokens: int = 0,
    iteration_token_budget: int = 0,
    prefix_len: int = 0,
) -> RequestPlan:
    """Phase-structured generation request: prefill over ``prompt_len``
    tokens (emits token 1) + decode steps against a growing KV cache.

    Decode traces are emitted once per power-of-two context bucket
    (``bucket``, 2x, 4x, ...) covering ``prompt_len + max_gen`` — the
    compiler caches one program per bucket, and the simulator picks a
    step's bucket from its live context. ``gen_len`` is the default
    tokens-per-request; per-request lengths (a generation-length
    distribution) are supplied at injection time and may use any
    length up to ``max_gen`` (defaults to ``gen_len``).

    ``prefill_chunk_tokens`` > 0 splits the prefill into SARATHI-style
    chunk phases of that many prompt tokens (the last chunk takes the
    remainder and carries the lm_head that emits token 1). Each chunk
    attends to the KV of the chunks before it, so chunk traces differ
    per position — the compiler still builds each one exactly once per
    (model shape, chunk size, ISA) through the shared ProgramCache.
    Prompts no longer than one chunk stay monolithic.

    ``iteration_token_budget`` > 0 *replaces* the static chunk knob
    with adaptive piggybacked iterations: the simulator sizes each
    prefill slice to (budget - live decode batch) and fuses it with
    the tenant's decode tokens into one :func:`piggyback_trace`
    program. The two knobs are mutually exclusive. The piggyback
    builder is attached for every generative plan so the budget can
    also be raised from 0 live (``ServingSession.
    set_iteration_token_budget``); with the budget at 0 it is never
    invoked.

    ``prefix_len`` > 0 declares the shared-prefix length (tokens) of
    this tenant's prompts: requests tagged with a prefix key attach to
    a refcounted shared KV entry of that many tokens, and a cache HIT
    prefills only the unshared suffix via :func:`kv_prefix_trace` (the
    ``prefix_builder`` attached here). 0 keeps the plan prefix-free —
    bit-identical to the pre-sharing engine.
    """
    if iteration_token_budget and prefill_chunk_tokens:
        raise ValueError(
            "iteration_token_budget replaces prefill_chunk_tokens "
            "(adaptive vs static chunking) — set at most one")
    if iteration_token_budget < 0:
        raise ValueError(
            f"iteration_token_budget must be >= 0 tokens, "
            f"got {iteration_token_budget}")
    if prefix_len < 0:
        raise ValueError(f"prefix_len must be >= 0 tokens, got {prefix_len}")
    if prefix_len >= prompt_len > 0:
        raise ValueError(
            f"prefix_len={prefix_len} must leave at least one unshared "
            f"suffix token of the {prompt_len}-token prompt")
    max_gen = max(max_gen, gen_len, 1)
    prefill = lm_trace(cfg, batch, prompt_len, "prefill", core,
                       include_head=include_head)
    chunk = int(prefill_chunk_tokens)
    chunks = []
    if chunk > 0 and prompt_len > chunk:
        start = 0
        while start < prompt_len:
            tokens = min(chunk, prompt_len - start)
            last_chunk = start + tokens >= prompt_len
            chunks.append(
                lm_trace(cfg, batch, tokens, "prefill", core,
                         include_head=include_head and last_chunk,
                         kv_prior=start))
            start += tokens
    decode = []
    if max_gen > 1:
        ctx = decode_bucket(prompt_len + 2, bucket)
        last = decode_bucket(prompt_len + max_gen, bucket)
        while True:
            decode.append((ctx, lm_trace(cfg, batch, ctx, "decode", core,
                                         include_head=include_head)))
            if ctx >= last:
                break
            ctx <<= 1
    def _piggyback(chunk_tokens: int, kv_prior: int, decode_batch: int,
                   decode_ctx: int, final: bool,
                   decode_groups=None) -> WorkloadTrace:
        return piggyback_trace(cfg, batch, chunk_tokens, kv_prior,
                               decode_batch, decode_ctx, core,
                               include_head=include_head, final=final,
                               decode_groups=decode_groups)

    kv_tok = kv_bytes_per_token(cfg, batch)

    def _swapin(context: int) -> WorkloadTrace:
        return kv_swapin_trace(cfg, batch, context, core)

    def _prefix(cached: int) -> WorkloadTrace:
        return kv_prefix_trace(cfg, batch, prompt_len, cached, core,
                               include_head=include_head)

    return RequestPlan(
        name=f"{cfg.name}:gen:b{batch}p{prompt_len}g{gen_len}",
        prefill=prefill, decode=decode, prompt_len=prompt_len,
        gen_len=gen_len, max_gen=max_gen, bucket_base=bucket,
        prefill_chunk_tokens=chunk if chunks else 0,
        prefill_chunks=chunks,
        iteration_token_budget=int(iteration_token_budget),
        piggyback_builder=_piggyback,
        kv_token_bytes=kv_tok,
        weight_bytes=float(cfg.param_count() * DTYPE),
        swapin_builder=_swapin if kv_tok > 0 else None,
        prefix_len=int(prefix_len) if kv_tok > 0 else 0,
        prefix_builder=_prefix if kv_tok > 0 else None,
    )


def train_trace(
    cfg: ModelConfig,
    batch: int,
    seq: int,
    core: NPUCoreConfig = DEFAULT_CORE,
) -> WorkloadTrace:
    """One training step ~ fwd + 2x bwd ME work + optimizer VE sweep."""
    fwd = lm_trace(cfg, batch, seq, "prefill", core)
    tr = WorkloadTrace(name=f"{cfg.name}:train:b{batch}s{seq}", core=core)
    for op in fwd.ops:
        tr.ops.append(op)
    for op in fwd.ops:
        if op.me_cycles > 0 or op.ve_cycles > 0:
            tr.ops.append(op.scaled(2.0))  # backward
    n_params = cfg.param_count()
    tr.ops.append(
        vector_op("adamw_update", n_params, core, flops_per_elem=12.0,
                  hbm_bytes=n_params * 12.0)
    )
    tr.hbm_footprint = n_params * (2 + 4 + 4 + 4)  # bf16 w + fp32 m,v,master
    return tr
