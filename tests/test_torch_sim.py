"""The port's fluid fleet simulator (``repro_torch.core.sim_torch``) on
the CPU: cell for cell against the reference's ``sim_jax`` on the same
programs, against the port's own discrete-event oracle in the bands of
``tests/test_sim_jax.py``, and frozen cells in a mixed batch.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import compile_neuisa as r_compile
from repro.core import sim_jax
from repro.npu.hw_config import DEFAULT_CORE as R_CORE
from repro.npu.hw_config import NPUCoreConfig as RCoreConfig
from repro.npu.workloads import get_workload as r_workload
from repro_torch import resolve_device
from repro_torch.core import (Simulator, TenantSpec, VNPUConfig, VNPUManager,
                              compile_neuisa)
from repro_torch.core import sim_torch
from repro_torch.npu.hw_config import DEFAULT_CORE, NPUCoreConfig
from repro_torch.npu.workloads import get_workload

PAIRS = [("RsNt", "DLRM"), ("BERT", "ENet"), ("ENet", "TFMR")]
SPLITS = (((2, 2), (2, 2)), ((3, 1), (3, 1)))
BW = (0.75, 1.0, 2.0)
FLOATS = ("makespan", "throughput", "me_util", "ve_util")
# Largest relative difference allowed between the port and the
# reference in the float leaves. Measured: 0 (bit-equal) in every cell
# of these grids and of all 78 pairs of the 12 workloads on an 8 ME /
# 8 VE core at 4 splits x 2 bandwidths, harvest on and off; the port
# reproduces XLA's fused multiply-adds and its flushing of subnormals.
REL_TOL = 0.0


def _programs(compile_fn, workload_fn, core, pairs=PAIRS):
    return [(compile_fn(workload_fn(a, core), core),
             compile_fn(workload_fn(b, core), core)) for a, b in pairs]


@pytest.fixture(scope="module")
def progs():
    """Each package compiles the pairs with its own compiler."""
    return (_programs(r_compile, r_workload, R_CORE),
            _programs(compile_neuisa, get_workload, DEFAULT_CORE))


def _assert_cells_equal(ref: dict, port: dict) -> None:
    ref = {k: np.asarray(v) for k, v in ref.items()}
    port = {k: v.cpu().numpy() for k, v in port.items()}
    assert sorted(port) == sorted(ref)
    assert port["events"].shape == ref["events"].shape
    np.testing.assert_array_equal(port["events"], ref["events"])
    for k in FLOATS:
        assert port[k].dtype == ref[k].dtype == np.float32, k
        assert port[k].shape == ref[k].shape, k
        np.testing.assert_allclose(port[k], ref[k], rtol=REL_TOL, atol=0,
                                   err_msg=k)


@pytest.mark.parametrize("harvest", [False, True])
def test_fleet_sweep_matches_reference(progs, harvest):
    ref = sim_jax.fleet_sweep(progs[0], hbm_scales=BW, n_requests=3,
                              harvest=harvest)
    port = sim_torch.fleet_sweep(progs[1], hbm_scales=BW, n_requests=3,
                                 harvest=harvest, device="cpu")
    assert port["makespan"].shape == (len(PAIRS), len(BW))
    _assert_cells_equal(ref, port)


@pytest.mark.parametrize("harvest", [False, True])
def test_sweep_collocations_matches_reference(progs, harvest):
    ref = sim_jax.sweep_collocations(progs[0], SPLITS, bw_points=BW,
                                     n_requests=4, harvest=harvest)
    port = sim_torch.sweep_collocations(progs[1], SPLITS, bw_points=BW,
                                        n_requests=4, harvest=harvest,
                                        device="cpu")
    assert port["makespan"].shape == (len(PAIRS), len(SPLITS), len(BW))
    _assert_cells_equal(ref, port)


@pytest.mark.parametrize("max_events", [37, 200_000])
def test_simulate_pair_matches_reference(progs, max_events):
    """One cell, run to its end or cut at 37 events (the loop's other
    exit: the cell freezes mid-request with its clock and counts)."""
    (r1, r2), (t1, t2) = progs[0][1], progs[1][1]
    ref = sim_jax.simulate_pair(sim_jax.pack_pair(r1, r2),
                                np.array([2.0, 2.0], np.float32),
                                np.array([3.0, 1.0], np.float32), 4,
                                max_events=max_events)
    port = sim_torch.simulate_pair(
        sim_torch.pack_pair(t1, t2, device="cpu"), (2.0, 2.0), (3.0, 1.0),
        4, max_events=max_events, device="cpu")
    assert port["throughput"].shape == (2,) and port["events"].dim() == 0
    assert (int(port["events"]) == 37) == (max_events == 37)
    _assert_cells_equal(ref, port)


CORE88 = NPUCoreConfig(n_me=8, n_ve=8)
# Cells of the 8 ME / 8 VE core where the port departs from a plain
# transcription of the reference, each run to max_events = 5000:
# (pair, (alloc_me, alloc_ve), bandwidth scale, harvest, stalls). The
# first two stall on a zero time step (F7): the reference steps on to
# max_events, the port jumps there; without the flush of subnormal
# finish times to zero they would end. The last two end; without the
# flush of subnormal remainders to zero they would stall.
EDGE_CELLS = [
    (("BERT", "DLRM"), ((7, 1), (1, 7)), 0.75, False, True),
    (("NCF", "NCF"), ((2, 6), (6, 2)), 1.0, False, True),
    (("DLRM", "NCF"), ((4, 4), (4, 4)), 0.75, False, False),
    (("TFMR", "NCF"), ((4, 4), (4, 4)), 0.75, True, False),
]
EDGE_MAX_EVENTS = 5000


@pytest.fixture(scope="module")
def progs88():
    """{workload: (reference program, port program)} on the 8/8 core."""
    r_core = RCoreConfig(n_me=8, n_ve=8)
    names = {n for cell in EDGE_CELLS for n in cell[0]}
    return {n: (r_compile(r_workload(n, r_core), r_core),
                compile_neuisa(get_workload(n, CORE88), CORE88))
            for n in names}


@pytest.mark.parametrize("cell", EDGE_CELLS,
                         ids=lambda c: "-".join(c[0]) + f"-{c[2]}-h{int(c[3])}")
def test_flush_and_stall_cells_match_reference(progs88, monkeypatch, cell):
    """The cells that the port's subnormal flushes and its stall jump
    decide, against the reference's jitted simulate_pair: events and
    every float leaf equal, stalled cells at max_events, and a stalled
    cell costs the port fewer loop iterations than max_events."""
    (a, b), (me, ve), bw, harvest, stalls = cell
    r_core = RCoreConfig(n_me=8, n_ve=8)
    run = jax.jit(functools.partial(
        sim_jax.simulate_pair, n_requests=4, harvest=harvest, core=r_core,
        max_events=EDGE_MAX_EVENTS))
    ref = run(sim_jax.pack_pair(progs88[a][0], progs88[b][0]),
              np.array(me, np.float32), np.array(ve, np.float32),
              hbm_scale=np.float32(bw))
    monkeypatch.setattr(sim_torch, "SYNC_EVERY", 1)
    monkeypatch.setattr(sim_torch, "iterations", 0)
    port = sim_torch.simulate_pair(
        sim_torch.pack_pair(progs88[a][1], progs88[b][1], device="cpu"),
        me, ve, 4, harvest=harvest, hbm_scale=bw, core=CORE88,
        max_events=EDGE_MAX_EVENTS, device="cpu")
    _assert_cells_equal(ref, port)
    assert (int(port["events"]) == EDGE_MAX_EVENTS) == stalls
    assert sim_torch.iterations < EDGE_MAX_EVENTS


def _oracle(w1, w2, policy, n_requests=4):
    core = DEFAULT_CORE
    mgr = VNPUManager(core=core)
    specs = []
    for name in (w1, w2):
        v = mgr.create(VNPUConfig(2, 2, hbm_bytes=1 << 30))
        specs.append(TenantSpec(compile_neuisa(get_workload(name, core),
                                               core), v, n_requests))
    return Simulator(specs, policy=policy, core=core).run()


@pytest.fixture(scope="module")
def fluid(progs):
    """Half-split cells of the PAIRS, harvest off and on, (P, S, B)."""
    return {h: sim_torch.sweep_collocations(
                progs[1], SPLITS, bw_points=BW, n_requests=4, harvest=h,
                device="cpu")
            for h in (False, True)}


def test_fluid_against_port_oracle(fluid):
    """tests/test_sim_jax.py's bands, against the port's own discrete
    simulator: no harvest within 2% of neu10_nh (the group model is
    exact there), harvest an optimistic bound of neu10 within ~2x,
    harvest never slower than no harvest, the oracle's pair ranking,
    and more bandwidth never slower."""
    nh = fluid[False]["makespan"][:, 0, 1].numpy()     # half split, bw 1
    h = fluid[True]["makespan"][:, 0, 1].numpy()
    oracle_nh = [_oracle(*p, "neu10_nh").makespan for p in PAIRS]
    oracle_h = [_oracle(*p, "neu10").makespan for p in PAIRS]
    for pair, f, o in zip(PAIRS, nh, oracle_nh):
        assert 0.98 < float(f) / o < 1.02, (pair, float(f) / o)
    for pair, f, o in zip(PAIRS, h, oracle_h):
        assert 0.45 < float(f) / o <= 1.02, (pair, float(f) / o)
    assert np.all(h <= nh * 1.02)
    assert np.argsort(oracle_nh).tolist() == np.argsort(nh).tolist()
    for out in fluid.values():
        ms = out["makespan"].numpy()
        assert np.all(ms[:, :, 0] >= ms[:, :, 2] * 0.999)
        assert np.all(out["me_util"].numpy() <= 1.0 + 1e-6)


@pytest.mark.parametrize("sync_every", [1, sim_torch.SYNC_EVERY])
def test_mixed_batch_freezes_finished_cells(monkeypatch, sync_every):
    """A pair that ends in a few events batched with one that takes
    thousands (and with a cell that stalls at max_events): each cell
    equals the same cell run alone, events and makespan included, for
    any number of iterations between host checks."""
    monkeypatch.setattr(sim_torch, "SYNC_EVERY", sync_every)
    core = NPUCoreConfig(n_me=8, n_ve=8)
    names = [("MNIST", "NCF"), ("BERT", "LLaMA"), ("BERT", "DLRM")]
    pairs = _programs(compile_neuisa, get_workload, core, names)
    splits = (((4, 4), (4, 4)), ((7, 1), (1, 7)))
    kw = dict(bw_points=(0.75,), n_requests=4, harvest=False, core=core,
              device="cpu")
    mixed = sim_torch.sweep_collocations(pairs, splits, **kw)
    ev = mixed["events"].numpy()
    assert ev[0].max() < 100 < 2000 < ev[1].min()
    assert ev[2, 1, 0] == 200_000           # stalls, see sim_torch
    for p in range(len(pairs)):
        for s in range(len(splits)):
            alone = sim_torch.sweep_collocations([pairs[p]], [splits[s]],
                                                 **kw)
            for k, v in alone.items():
                assert torch.equal(v[0, 0], mixed[k][p, s]), (p, s, k)


def test_default_device_is_cuda(progs):
    """With no device the simulator runs on cuda; without a card it
    raises instead of dropping to the CPU."""
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim_torch.fleet_sweep(progs[1], n_requests=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim_torch.pack_pair(*progs[1][0])
