"""The collectives (or, with ``--flops``, the matmuls) of one dry-run
cell, op by op, in the port or in the reference.

    PYTHONPATH=src python scripts/dryrun_collectives.py \\
        --arch qwen2-0.5b --shape train_4k --mesh single [--no-early-stop]
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/dryrun_collectives.py \\
        --arch qwen2-0.5b --shape train_4k --mesh single --ref

The port's (``repro_torch.launch.dryrun.analyze_cell``): each collective
``OpCounter`` counts, grouped by kind, dtype and shape, with its count
and weighted bytes. ``--no-early-stop`` runs the cell with torch's
checkpoint recomputing each layer whole in the backward
(``set_checkpoint_early_stop(False)``). ``--ref``, the reference's
(``repro.launch.dryrun``; needs JAX, and forces 512 host devices when
imported, so give it a process of its own): each collective of its
partitioned HLO with its type, its operand and the trip count of the
loop it sits in. ``--flops`` lists the matmuls instead: the port's
grouped by op and operand shapes, the reference's each dot of its HLO
with its result, its lhs and its trip count, each with its FLOPs. Both
end with the row's per-device totals.
"""
import argparse
import collections
import json
import math
import re


def _port(args) -> None:
    import torch
    import torch.utils.checkpoint as ckpt

    from repro_torch.configs import ARCHS, SHAPES_BY_NAME
    from repro_torch.launch import dryrun, op_analysis as O
    from repro_torch.launch.mesh import make_production_mesh, process_group

    seen = collections.Counter()
    dots = collections.Counter()
    count = O.OpCounter.__torch_dispatch__

    def logged(self, func, types, args_=(), kwargs=None):
        before = self.flops
        out = count(self, func, types, args_, kwargs)
        if out is NotImplemented or self._propagation():
            return out
        if self.flops != before:
            dots[(func._opname, tuple(tuple(a.shape) for a in args_
                                      if isinstance(a, torch.Tensor)))] += \
                self.flops - before
        kind = O._COLL_KIND.get(func._opname) if func.namespace in \
            O._COLL_NAMESPACES else None
        if kind:
            t = O._tensors(out)[0]
            seen[(kind, str(t.dtype).replace("torch.", ""),
                  tuple(t.shape), t.element_size())] += 1
        return out

    O.OpCounter.__torch_dispatch__ = logged
    world, multi_pod = dryrun.MESHES[args.mesh]
    with ckpt.set_checkpoint_early_stop(not args.no_early_stop), \
            process_group("fake", world):
        row = dryrun.analyze_cell(args.arch, ARCHS[args.arch],
                                  SHAPES_BY_NAME[args.shape],
                                  make_production_mesh(multi_pod=multi_pod),
                                  args.mesh)
    if args.flops:
        for (op, shapes), f in sorted(dots.items(), key=lambda kv: -kv[1]):
            print(f"{op:10s} {str(shapes):60s} {f:.6e}")
    for (kind, dt, shape, size), n in sorted(
            seen.items(), key=lambda kv: -math.prod(kv[0][2]) * kv[1]):
        if args.flops:
            break
        b = math.prod(shape) * size * O._FACTORS[kind] * n
        print(f"{kind:15s} {dt:9s} {str(shape):24s} x{n:<5d} {b:.6e}")
    _totals(row, torch.__version__)


def _ref(args) -> None:
    import jax

    from repro.launch import dryrun, hlo_analysis as H

    hlo = {}
    metrics = dryrun.hlo_metrics

    def captured(text, **kw):
        hlo["text"], hlo["kw"] = text, kw
        return metrics(text, **kw)

    dryrun.hlo_metrics = captured
    row = dryrun.analyze_cell(
        args.arch, dryrun.ARCHS[args.arch], dryrun.SHAPES_BY_NAME[args.shape],
        dryrun.make_production_mesh(multi_pod=args.mesh == "multi"),
        args.mesh)
    comps = H._split_computations(hlo["text"])
    mult = H._multipliers(hlo["text"], comps,
                          hlo["kw"].get("branch_scale", 1.0))
    for name, lines in comps.items():
        w = mult.get(name, 0.0)
        if args.flops and w > 0:
            table = {}
            for ln in lines:
                mm = re.match(r"\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)", ln)
                if mm:
                    table[mm.group(1)] = mm.group(2)
            for ln in lines:
                if " dot(" in ln:
                    m = H._DOT_RE.search(ln)
                    lhs = H._split_top_level(m.group(2))[0].split(" ")[-1]
                    ref = table.get(lhs.lstrip("%"), "")
                    lhs_shape = H._SHAPE_RE.search(ref)
                    print(f"dot {m.group(1)[:32]:32s} lhs "
                          f"{lhs_shape.group(0) if lhs_shape else '?':24s} "
                          f"x{w:<6g} {H._dot_flops(ln, table) * w:.6e} "
                          f"in {name}")
            continue
        for ln in lines if w > 0 else ():
            m = H._COLL_RE.search(ln)
            if not m or "-done(" in ln:
                continue
            shape, kind = m.group(1), m.group(2)
            b = H._shape_bytes(shape) * H._FACTORS[kind] * w
            operand = re.search(r"\((%[\w.\-]+)", ln[m.end() - 1:])
            shape = re.sub(r"\{[\d,]*\}", "", shape)   # layouts
            print(f"{kind:15s} {shape:44s} x{w:<6g} {b:.6e} "
                  f"of {operand.group(1) if operand else '(tuple)'} "
                  f"in {name}")
    _totals(row, f"jax {jax.__version__}")


def _totals(row, release) -> None:
    print(json.dumps({k: row[k] for k in
                      ("arch", "shape", "mesh", "status", "flops_per_device",
                       "collective_bytes_per_device", "collectives")}
                     | {"release": release}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--ref", action="store_true")
    ap.add_argument("--no-early-stop", action="store_true")
    ap.add_argument("--flops", action="store_true",
                    help="list the matmuls and their FLOPs, not collectives")
    args = ap.parse_args()
    (_ref if args.ref else _port)(args)


if __name__ == "__main__":
    main()
