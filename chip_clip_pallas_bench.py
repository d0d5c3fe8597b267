#!/usr/bin/env python3
"""Time the Pallas kernel's clip, ``csrc/clip_pallas.cu``, on one NVIDIA GPU.

    python3 chip_clip_pallas_bench.py [--old OLD.cu ...] [--old-rule RULE]
                                      [--sweep] [--sass] [--out PATH.json]

At phase 2b's five shapes of ``chip_smoke.py`` (``pallas_shapes``: the quad
lattice's first-step overlap and wall pairs, the stars' active-pair pool
batch, 4,096 pairs of 64x64 slots and the default capacity, 163,840 pairs of
64 slots with 10-30 real vertices), in float32 and in one process, it times:

* the kernel at the wrapper's lane group ``kernels/clip_pallas.lane_group``,
  and clip.cu (``csrc/clip.cu``) on the same inputs,
  for the ratio between them;
* its floor: the same shape with every slot set to vertex 0, so there are no
  real edges and the kernel only stages, compacts and writes; the
  difference is the time of the edge-pair loops;
* ``--old`` (repeatable): another build with the same C interface, e.g.
  the first version, ``git show f1a635a:subzero_tpu_torch/csrc/
  clip_pallas.cu``, written into the gitignored ``_checkout/`` with
  ``clip_tile.cuh`` beside it; each runs at clip.cu's lane groups
  (``kernels/clip.py:lane_group``, the first version's rule) or, with
  ``--old-rule pallas``, at the kernel's, in turns with the kernel (old,
  new, new, old) on preallocated outputs, and its results are compared
  with the kernel's (max |d area|, n_cross mismatches);
* ``--sweep``: the kernel at every lane group whose tile fits;
* ``--sass``: ``cuobjdump -sass`` of each build, written beside ``--out``,
  and for every kernel instance its loops (each backward branch, with the
  instructions between its target and itself; innermost loops marked).

Every time is the card's alone (``chip_smoke.card_ms``: CUDA events behind
a spin kernel), with the wrapper-free launch's host microseconds beside it;
the kernel's launch-inclusive time (``chip_smoke.cuda_ms``) is kept in the
JSON.  Prints one line per measurement, the card's name, power limit and
maximum SM clock, and writes every row to ``--out`` (by default
``subzero_tpu_torch/_build/clip_pallas_bench.json``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import chip_smoke as smoke

P = ctypes.c_void_p


def load(source):
    """The ``clip_pallas_stats_f32`` entry of ``source``, built with the
    kernel's flags; prints ptxas's registers and spills per instance."""
    from subzero_tpu_torch.kernels import clip as kclip

    so, _, log = kclip.compile_source(Path(source))
    fn = ctypes.CDLL(str(so)).clip_pallas_stats_f32
    fn.argtypes = [P, P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_int] + [P] * 5
    fn.restype = ctypes.c_int
    for r in smoke.ptxas_instances(log):
        smoke.log(f"[ptxas] {Path(source).name} {r['name']}: "
                  f"{r.get('regs')} registers, {r.get('spill_st')} B spill "
                  f"stores, {r.get('spill_ld')} B spill loads")
    return fn, so


def sass_loops(text):
    """{kernel instance: [(first, last, instructions, innermost)]} of a
    ``cuobjdump -sass`` listing: one entry per backward branch, its target
    to itself (16 bytes a Hopper instruction)."""
    out, name, loops = {}, None, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            loops = out.setdefault(name, [])
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?BRA\s+"
                      r"(?:\S+\s+)?0x([0-9a-f]+)", line)
        if m and loops is not None:
            at, to = int(m.group(1), 16), int(m.group(3), 16)
            if to <= at:
                loops.append([to, at, (at - to) // 16 + 1])
    for name, loops in out.items():
        for lp in loops:
            lp.append(not any(o is not lp and lp[0] <= o[0] and o[1] <= lp[1]
                              for o in loops))
    return out


def dump_sass(so, where):
    """Write ``cuobjdump -sass`` of library ``so`` to ``where`` and print
    its loops per kernel instance."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    where.write_text(text)
    for name, loops in sass_loops(text).items():
        k = re.search(r"clip_pallas_kernelILi(\d+)E", name)
        label = f"G={k.group(1)}" if k else name
        smoke.log(f"[sass] {where.name} {label}: loops (first, last, "
                  f"instructions, innermost) "
                  + ", ".join(f"({a:#x}, {b:#x}, {n}, {'inner' if i else '-'})"
                              for a, b, n, i in loops))
    return text


def timed(fn):
    """{"card_ms": card alone, "host_us": per call, "ms": launch-inclusive}."""
    card, host = smoke.card_ms(fn)
    return {"card_ms": card, "host_us": host, "ms": smoke.cuda_ms(fn)}


def main() -> int:
    import torch

    from subzero_tpu_torch.geometry.clip_pallas import EPS_SCALE
    from subzero_tpu_torch.kernels import clip as kclip
    from subzero_tpu_torch.kernels import clip_pallas as kpallas

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", action="append", default=[],
                    help="another build's source, same C interface "
                         "(repeatable)")
    ap.add_argument("--old-rule", choices=("clip", "pallas"),
                    default="clip",
                    help="the lane groups of the --old builds: clip.cu's "
                         "rule (the first version's) or the kernel's")
    ap.add_argument("--sweep", action="store_true",
                    help="time every lane group that fits")
    ap.add_argument("--sass", action="store_true",
                    help="dump each build's SASS beside --out")
    ap.add_argument("--out",
                    default=str(kclip.BUILD_DIR / "clip_pallas_bench.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_clip_pallas_bench: CUDA is not available",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    smoke.log(f"[bench] {smi}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)

    new, new_so = load(kpallas.SOURCE)
    olds = [(path, *load(path)) for path in args.old]
    old_rule = kclip.lane_group if args.old_rule == "clip" \
        else kpallas.lane_group
    if args.sass:
        dump_sass(new_so, out.with_name("clip_pallas.sass"))
        for k, (_, _, so) in enumerate(olds):
            dump_sass(so, out.with_name(f"clip_pallas_old{k}.sass"))
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for name, a, b, diff, _ in smoke.pallas_shapes(smoke.main_path_runs()):
        n, vp, vq = a.shape[0], a.shape[1], b.shape[1]
        g0 = kpallas.lane_group(n, vp, vq)
        bound, by, nbytes, flops = smoke.clip_bound_ms(a, b)
        edge_pairs = float((smoke.real_edges(a) * smoke.real_edges(b)).sum())

        def runner(fn, lanes, a=a, b=b):
            outs = (torch.empty(n, device="cuda"),
                    torch.empty(n, 2, device="cuda"),
                    torch.empty(n, 2, device="cuda"),
                    torch.empty(n, dtype=torch.int32, device="cuda"))
            ptrs = [o.data_ptr() for o in outs]

            def go():
                err = fn(a.data_ptr(), b.data_ptr(), n, vp, vq, int(diff),
                         EPS_SCALE, lanes, *ptrs, stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            return go, outs

        run_new, out_new = runner(new, g0)
        run_new()
        row = {"shape": name, "B": n, "Vp": vp, "Vq": vq, "G": g0,
               "bound_ms": bound, "bound_by": by, "bytes": nbytes,
               "flops": flops, "real_edge_pairs": edge_pairs}
        row["new"], row["old"] = [], []
        for path, old, _ in olds:
            g_old = old_rule(n, vp, vq)
            run_old, out_old = runner(old, g_old)
            run_old()
            torch.cuda.synchronize()
            d_area = float((out_old[0] - out_new[0]).abs().max())
            bad = int((out_old[3] != out_new[3]).sum())
            t = [timed(run_old), timed(run_new), timed(run_new),
                 timed(run_old)]
            row["old"].append({"source": path, "G": g_old,
                               "runs": [t[0], t[3]],
                               "max_abs_d_area": d_area,
                               "n_cross_mismatches": bad})
            row["new"] += [t[1], t[2]]
            old_ms = (t[0]["card_ms"] + t[3]["card_ms"]) / 2
            new_ms = (t[1]["card_ms"] + t[2]["card_ms"]) / 2
            smoke.log(f"[bench] {name}: old {path} (G={g_old}) "
                      f"{t[0]['card_ms']:.4f}/{t[3]['card_ms']:.4f} ms, new "
                      f"(G={g0}) {t[1]['card_ms']:.4f}/{t[2]['card_ms']:.4f}"
                      f" ms card alone, old/new {old_ms / new_ms:.2f}x; old "
                      f"max|d area| {d_area:.3e}, n_cross mismatches {bad}")
        if not olds:
            row["new"] = [timed(run_new)]
        card = sum(r["card_ms"] for r in row["new"]) / len(row["new"])
        cu, _ = smoke.card_ms(lambda: kclip.clip_stats_cuda(a, b, diff))
        row["clip_cu_card_ms"] = cu
        smoke.log(f"[bench] {name} B={n} Vp={vp} Vq={vq}: new (G={g0}) "
                  f"{card:.4f} ms card alone; bound {bound:.4f} ms ({by}), "
                  f"share {bound / card:.1%}; clip.cu {cu:.4f} ms, ratio "
                  f"{card / cu:.2f}; {edge_pairs:.6g} real edge pairs")

        # the floor: same shape and bytes, no real edges
        flat_a = a[:, :1].expand_as(a).contiguous()
        flat_b = b[:, :1].expand_as(b).contiguous()
        run_flat, out_flat = runner(new, g0, flat_a, flat_b)
        run_flat()
        torch.cuda.synchronize()
        if bool(out_flat[0].any()) or bool(out_flat[3].any()):
            raise AssertionError(f"{name}: collapsed pairs gave a non-zero "
                                 f"area or crossing")
        floor = timed(run_flat)
        loops = card - floor["card_ms"]
        row["floor"] = floor
        smoke.log(f"[bench] {name}: floor (no real edges) "
                  f"{floor['card_ms']:.4f} ms card alone, so the edge-pair "
                  f"loops take {loops:.4f} ms of {card:.4f}: "
                  f"{loops * 1e6 / max(edge_pairs, 1):.4f} ns per real edge "
                  f"pair")
        del flat_a, flat_b
        if args.sweep:
            row["sweep"] = {}
            for g in (1, 2, 4, 8, 16, 32):
                if kclip.tile_bytes(g, vp, vq, 4) > kclip.SMEM_LIMIT:
                    continue
                row["sweep"][g] = timed(runner(new, g)[0])
                smoke.log(f"[sweep] {name} G={g:2d}: "
                          f"{row['sweep'][g]['card_ms']:.4f} ms card alone")
        rows.append(row)
        del a, b
        torch.cuda.empty_cache()

    out.write_text(json.dumps({"card": smi, "rows": rows}, indent=1))
    smoke.log(f"[bench] {smi}; written {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
