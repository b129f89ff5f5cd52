"""``scripts/dryrun_sweep_check.py`` and its committed reference table,
with no JAX and no sweep: the table holds exactly the rows the port's dry
run enumerates, and the check passes a row in its band and fails one out
of it or missing."""
import importlib.util
import json
from pathlib import Path

import pytest

from repro_torch.configs import ALL_SHAPES, ARCHS, shape_applicable
from repro_torch.launch import dryrun
from repro_torch.launch.dryrun_expect import (DRYRUN_COLL_EXPECT_CELLS,
                                              DRYRUN_COLL_RTOL,
                                              DRYRUN_FLOPS_RTOL)

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "dryrun_sweep_check", ROOT / "scripts" / "dryrun_sweep_check.py")
check = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(check)


def _cells():
    """{(arch, shape, mesh): "ok" or "skip"} as ``repro_torch.launch.dryrun``
    enumerates them."""
    return {(arch, cell.name, mesh): "ok" if shape_applicable(cfg, cell)[0]
            else "skip"
            for mesh in dryrun.MESHES for arch, cfg in ARCHS.items()
            for cell in ALL_SHAPES}


def test_reference_table_holds_every_row():
    header, ref = check.read_reference()
    assert header["jax"] and header["jaxlib"] and header["rows"] == len(ref)
    assert {k: r["status"] for k, r in ref.items()} == _cells()
    ok = [r for r in ref.values() if r["status"] == "ok"]
    assert len(ok) == 64
    assert all(r["flops_per_device"] > 0 and r["collective_bytes_per_device"] > 0
               for r in ok)
    # every stated row is a row of the table
    assert set(DRYRUN_COLL_EXPECT_CELLS) <= {k for k, r in ref.items()
                                             if r["status"] == "ok"}
    assert DRYRUN_COLL_RTOL == DRYRUN_FLOPS_RTOL == 0.10


def _port_from(ref, scale=None):
    """A synthetic port sweep: each reference row at its expected ratio
    (times ``scale``'s factor for the cells it names)."""
    out = {}
    for (arch, shape, mesh), r in ref.items():
        row = dict(r)
        if r["status"] == "ok":
            kind = check.SHAPES_BY_NAME[shape].kind
            f = check.coll_expect(arch, shape, mesh, kind)
            f *= (scale or {}).get((arch, shape, mesh), 1.0)
            row["collective_bytes_per_device"] = r["collective_bytes_per_device"] * f
        out[(arch, shape, mesh)] = row
    return out


def _write(tmp_path, rows):
    path = tmp_path / "sweep.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows.values()))
    return str(path)


def test_sweep_check_passes_rows_in_their_band(tmp_path, capsys):
    _, ref = check.read_reference()
    cell = ("qwen2-0.5b", "train_4k", "single")
    port = _port_from(ref, {cell: 1.09})            # inside the 10% band
    assert check.main([_write(tmp_path, port)]) == 0
    out = capsys.readouterr().out
    assert "80 of 80 rows held" in out and "FAIL" not in out
    assert check.main([_write(tmp_path, port), "--same-as",
                       _write(tmp_path, port)]) == 0


@pytest.mark.parametrize("fault", ["coll", "flops", "missing", "release"])
def test_sweep_check_fails_a_row(fault, tmp_path, capsys):
    _, ref = check.read_reference()
    cell = ("internvl2-1b", "decode_32k", "single")
    port = _port_from(ref)
    other = None
    if fault == "coll":             # F18's ratio: no logits all-reduce
        port[cell]["collective_bytes_per_device"] *= 0.0926 / 0.5
    elif fault == "flops":
        port[cell]["flops_per_device"] *= 1.11
    elif fault == "missing":
        del port[cell]
    else:
        other = {k: dict(r) for k, r in port.items()}
        other[cell]["collective_bytes_per_device"] *= 1.02
    args = [_write(tmp_path, port)]
    if other:
        path = tmp_path / "other.jsonl"
        path.write_text("".join(json.dumps(r) + "\n" for r in other.values()))
        args += ["--same-as", str(path)]
    assert check.main(args) == 1
    out = capsys.readouterr().out
    failed = out.split("FAILED:")[1]
    assert "internvl2-1b x decode_32k x single" in failed
    assert len(failed.strip().splitlines()) == 1
