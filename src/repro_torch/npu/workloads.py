"""Paper Table I workload proxies + assigned-arch tenants.

The paper evaluates MLPerf v2.1 + TPU reference models traced on real
TPUv4s. Without TPU access we rebuild each workload's *operator-level
character* (ME:VE intensity ratio, HBM traffic, op-length
distribution — Figs. 2–7) from its published architecture, through
the same analytic cost model used for the assigned archs. Conv nets
use im2col-GEMM ME costs (how XLA maps convs to the MXU); depthwise
convs and BN/ReLU/SE epilogues land on the VEs; DLRM/NCF embedding
lookups are HBM gathers.

Everything returns a ``WorkloadTrace`` — the same schema the Neu10
simulator replays.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.npu.cost_model import (
    Operator,
    WorkloadTrace,
    matmul_op,
    memory_op,
    vector_op,
)
from repro_torch.npu.hw_config import DEFAULT_CORE, NPUCoreConfig
from repro_torch.npu.trace import lm_trace

DTYPE = 2


# ----------------------------------------------------------------------
# conv building blocks (im2col-GEMM on the MXU)
# ----------------------------------------------------------------------
def _conv(
    name: str, B: int, hw: int, cin: int, cout: int, k: int,
    core: NPUCoreConfig, stride: int = 1, ve_epilogue: float = 4.0,
) -> Operator:
    out_hw = max(hw // stride, 1)
    m = B * out_hw * out_hw
    op = matmul_op(name, m, cin * k * k, cout, core,
                   ve_post_elems=m * cout * ve_epilogue)
    return op


def _depthwise(
    name: str, B: int, hw: int, c: int, k: int, core: NPUCoreConfig,
    stride: int = 1,
) -> Operator:
    out_hw = max(hw // stride, 1)
    # no reduction dim -> lands on the VEs (k*k MACs per element)
    return vector_op(name, B * out_hw * out_hw * c, core,
                     flops_per_elem=float(k * k + 4))


# ----------------------------------------------------------------------
# Table I proxies
# ----------------------------------------------------------------------
def bert_like(B: int = 32, core: NPUCoreConfig = DEFAULT_CORE) -> WorkloadTrace:
    cfg = ModelConfig(
        name="BERT", family="dense", n_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=16, d_ff=4096, vocab_size=30522, mlp_gated=False,
    )
    tr = lm_trace(cfg, B, 384, "prefill", core, include_head=False)
    tr.name = f"BERT:b{B}"
    tr.hbm_footprint = 1.27 * 1024**3  # Table I
    return tr


def tfmr_like(B: int = 32, core: NPUCoreConfig = DEFAULT_CORE) -> WorkloadTrace:
    cfg = ModelConfig(
        name="TFMR", family="dense", n_layers=6, d_model=1024, n_heads=16,
        n_kv_heads=16, d_ff=4096, vocab_size=33708, mlp_gated=False,
    )
    tr = lm_trace(cfg, B, 256, "prefill", core, include_head=True)
    tr.name = f"TFMR:b{B}"
    tr.hbm_footprint = 1.54 * 1024**3
    return tr


def dlrm_like(B: int = 32, core: NPUCoreConfig = DEFAULT_CORE) -> WorkloadTrace:
    tr = WorkloadTrace(name=f"DLRM:b{B}", core=core)
    n_tables, dim = 26, 128
    # embedding gathers: pooled multi-hot (avg ~40 ids/table) — pure HBM
    ids_per_table = 40
    tr.ops.append(
        memory_op("emb_gather", B * n_tables * ids_per_table * dim * 4.0,
                  core, ve_elems=B * n_tables * ids_per_table * dim)
    )
    # bottom MLP 13-512-256-128
    for i, (a, b) in enumerate([(13, 512), (512, 256), (256, 128)]):
        tr.ops.append(matmul_op(f"bot_mlp{i}", B, a, b, core,
                                ve_post_elems=B * b * 2))
    # pairwise interaction: (27x128) dot products per sample — VE
    tr.ops.append(vector_op("interact", B * 27 * 27 * dim / 2, core,
                            flops_per_elem=2.0))
    # top MLP 1024-1024-512-256-1
    for i, (a, b) in enumerate([(479, 1024), (1024, 1024), (1024, 512),
                                (512, 256), (256, 1)]):
        tr.ops.append(matmul_op(f"top_mlp{i}", B, a, b, core,
                                ve_post_elems=B * b * 2))
    tr.hbm_footprint = 22.38 * 1024**3
    return tr


def ncf_like(B: int = 32, core: NPUCoreConfig = DEFAULT_CORE) -> WorkloadTrace:
    tr = WorkloadTrace(name=f"NCF:b{B}", core=core)
    dim = 64
    tr.ops.append(memory_op("emb_gather", B * 4 * dim * 4.0 * 256, core,
                            ve_elems=B * 4 * dim * 64))
    for i, (a, b) in enumerate([(256, 256), (256, 128), (128, 64), (64, 1)]):
        tr.ops.append(matmul_op(f"mlp{i}", B, a, b, core,
                                ve_post_elems=B * b * 2))
    tr.ops.append(vector_op("gmf_mul", B * dim * 4, core))
    tr.hbm_footprint = 11.10 * 1024**3
    return tr


def _resnet_stages(tr: WorkloadTrace, B: int, core: NPUCoreConfig,
                   width: float = 1.0) -> None:
    w = lambda c: int(c * width)
    tr.ops.append(_conv("stem", B, 112, 3, w(64), 7, core, stride=1))
    tr.ops.append(vector_op("maxpool", B * 56 * 56 * w(64), core))
    stages = [(56, 64, 256, 3), (28, 128, 512, 4), (14, 256, 1024, 6),
              (7, 512, 2048, 3)]
    for hw, mid, out, blocks in stages:
        for b in range(blocks):
            tr.ops.append(_conv(f"c1_{hw}_{b}", B, hw, w(out), w(mid), 1, core))
            tr.ops.append(_conv(f"c3_{hw}_{b}", B, hw, w(mid), w(mid), 3, core))
            tr.ops.append(_conv(f"c1b_{hw}_{b}", B, hw, w(mid), w(out), 1, core))
            tr.ops.append(vector_op(f"res_{hw}_{b}", B * hw * hw * w(out) * 2,
                                    core))


def resnet_like(B: int = 32, core: NPUCoreConfig = DEFAULT_CORE) -> WorkloadTrace:
    tr = WorkloadTrace(name=f"RsNt:b{B}", core=core)
    _resnet_stages(tr, B, core)
    tr.ops.append(matmul_op("fc", B, 2048, 1000, core))
    tr.hbm_footprint = 216.02 * 1024**2
    return tr


def resnetrs_like(B: int = 32, core: NPUCoreConfig = DEFAULT_CORE) -> WorkloadTrace:
    tr = WorkloadTrace(name=f"RNRS:b{B}", core=core)
    _resnet_stages(tr, B, core, width=1.3)
    # ResNet-RS adds SE blocks -> extra VE
    tr.ops.append(vector_op("se_blocks", B * 16 * 2048 * 8, core))
    tr.ops.append(matmul_op("fc", B, 2662, 1000, core))
    tr.hbm_footprint = 458.17 * 1024**2
    return tr


def efficientnet_like(B: int = 32, core: NPUCoreConfig = DEFAULT_CORE) -> WorkloadTrace:
    tr = WorkloadTrace(name=f"ENet:b{B}", core=core)
    # MBConv stages (B0-ish): expand 1x1 (ME), depthwise (VE), SE (VE),
    # project 1x1 (ME) — the paper's canonical mixed/high-contention load.
    stages = [(112, 16, 24, 2, 3), (56, 24, 40, 2, 5), (28, 40, 80, 3, 3),
              (14, 80, 112, 3, 5), (14, 112, 192, 4, 5), (7, 192, 320, 1, 3)]
    for hw, cin, cout, blocks, k in stages:
        for b in range(blocks):
            exp = cin * 6
            tr.ops.append(_conv(f"expand_{hw}_{b}", B, hw, cin, exp, 1, core))
            tr.ops.append(_depthwise(f"dw_{hw}_{b}", B, hw, exp, k, core))
            tr.ops.append(vector_op(f"se_{hw}_{b}", B * exp * 32, core,
                                    flops_per_elem=4.0))
            tr.ops.append(_conv(f"proj_{hw}_{b}", B, hw, exp, cout, 1, core))
            cin = cout
    tr.ops.append(matmul_op("head", B, 1280, 1000, core))
    tr.hbm_footprint = 99.06 * 1024**2
    return tr


def _det_head(tr: WorkloadTrace, B: int, core: NPUCoreConfig,
              levels=(64, 32, 16, 8), c: int = 256, ve_scale: float = 4.0) -> None:
    for hw in levels:
        for i in range(4):
            tr.ops.append(_conv(f"head{hw}_{i}", B, hw, c, c, 3, core))
        tr.ops.append(vector_op(f"post{hw}", B * hw * hw * c * ve_scale, core))


def retinanet_like(B: int = 32, core: NPUCoreConfig = DEFAULT_CORE) -> WorkloadTrace:
    tr = WorkloadTrace(name=f"RtNt:b{B}", core=core)
    _resnet_stages(tr, B, core)
    _det_head(tr, B, core)
    tr.hbm_footprint = 860.51 * 1024**2
    return tr


def maskrcnn_like(B: int = 8, core: NPUCoreConfig = DEFAULT_CORE) -> WorkloadTrace:
    tr = WorkloadTrace(name=f"MRCN:b{B}", core=core)
    _resnet_stages(tr, B, core)
    _det_head(tr, B, core, ve_scale=8.0)
    # ROIAlign + per-ROI mask head: gather-heavy VE work
    tr.ops.append(vector_op("roi_align", B * 512 * 14 * 14 * 256, core,
                            flops_per_elem=4.0))
    for i in range(4):
        tr.ops.append(_conv(f"mask{i}", B * 4, 14, 256, 256, 3, core))
    tr.hbm_footprint = 3.21 * 1024**3
    return tr


def shapemask_like(B: int = 8, core: NPUCoreConfig = DEFAULT_CORE) -> WorkloadTrace:
    tr = WorkloadTrace(name=f"SMask:b{B}", core=core)
    _resnet_stages(tr, B, core)
    _det_head(tr, B, core, ve_scale=6.0)
    tr.ops.append(vector_op("shape_prior", B * 1024 * 32 * 32, core,
                            flops_per_elem=6.0))
    tr.hbm_footprint = 6.04 * 1024**3
    return tr


def mnist_like(B: int = 32, core: NPUCoreConfig = DEFAULT_CORE) -> WorkloadTrace:
    tr = WorkloadTrace(name=f"MNIST:b{B}", core=core)
    tr.ops.append(_conv("c1", B, 28, 1, 32, 3, core))
    tr.ops.append(_conv("c2", B, 14, 32, 64, 3, core))
    tr.ops.append(matmul_op("fc1", B, 3136, 128, core, ve_post_elems=B * 128))
    tr.ops.append(matmul_op("fc2", B, 128, 10, core))
    tr.hbm_footprint = 10.59 * 1024**2
    return tr


def llama2_13b_decode(B: int = 8, core: NPUCoreConfig = DEFAULT_CORE,
                      S: int = 512) -> WorkloadTrace:
    """§V-F case study: HBM-bound LLM decode tenant."""
    cfg = ModelConfig(
        name="LLaMA2-13B", family="dense", n_layers=40, d_model=5120,
        n_heads=40, n_kv_heads=40, d_ff=13824, vocab_size=32000,
        rope_theta=10_000.0,
    )
    tr = lm_trace(cfg, B, S, "decode", core)
    tr.name = f"LLaMA:b{B}s{S}"
    return tr


# ----------------------------------------------------------------------
WORKLOADS = {
    "BERT": bert_like,
    "TFMR": tfmr_like,
    "DLRM": dlrm_like,
    "NCF": ncf_like,
    "MRCN": maskrcnn_like,
    "RtNt": retinanet_like,
    "SMask": shapemask_like,
    "MNIST": mnist_like,
    "RsNt": resnet_like,
    "RNRS": resnetrs_like,
    "ENet": efficientnet_like,
    "LLaMA": llama2_13b_decode,
}

# §V-A pairs: (low | medium | high) ME/VE contention
PAPER_PAIRS: List[Tuple[str, str, str]] = [
    ("DLRM", "SMask", "low"),
    ("DLRM", "RtNt", "low"),
    ("NCF", "RsNt", "low"),
    ("ENet", "SMask", "medium"),
    ("BERT", "ENet", "medium"),
    ("ENet", "MRCN", "medium"),
    ("ENet", "TFMR", "high"),
    ("MNIST", "RtNt", "high"),
    ("RNRS", "RtNt", "high"),
]

_BATCH_OVERRIDES = {"MRCN": 8, "SMask": 8, "LLaMA": 8}


def get_workload(name: str, core: NPUCoreConfig = DEFAULT_CORE,
                 batch: int = 32) -> WorkloadTrace:
    b = _BATCH_OVERRIDES.get(name, batch)
    return WORKLOADS[name](b, core)


def assigned_arch_tenant(
    cfg: ModelConfig, phase: str = "prefill", batch: int = 8, seq: int = 512,
    core: NPUCoreConfig = DEFAULT_CORE,
) -> WorkloadTrace:
    """Any assigned architecture as a Neu10 vNPU tenant."""
    return lm_trace(cfg, batch, seq, phase, core)
