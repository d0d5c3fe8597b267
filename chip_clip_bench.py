#!/usr/bin/env python3
"""Time the CUDA clip kernel against an earlier build of it, on one NVIDIA GPU.

    python3 chip_clip_bench.py [--old OLD.cu] [--sweep] [--out PATH.json]

At four shapes — the main path's overlap and wall pairs (first step of the
10,240-floe quad lattice, as ``chip_smoke.py`` builds them), 4,096 pairs of
64x64 slots, and the model's default capacity (163,840 pairs of 64 slots with
10-30 real vertices) — it times, in float32 and in one process:

* the kernel of ``subzero_tpu_torch/csrc/clip.cu`` at the wrapper's lane
  group ``lane_group(B, Vp, Vq)``;
* its floor: the same kernel on the same shape with every slot set to vertex
  0, so there are no real edges and it only stages, compacts and writes; the
  difference is the time of the edge-pair loops;
* ``--old``: a source with the earlier C interface (no lane argument), e.g.
  the first kernel, ``git show 9a1d2e1:subzero_tpu_torch/csrc/clip.cu``;
* ``--sweep``: the kernel at every lane group whose tile fits.

Every time is taken two ways: ``chip_smoke.cuda_ms`` (CUDA events around 20
back-to-back calls, host launch cost included: the ``ms`` of chip_smoke's
kernel record) and ``chip_smoke.card_ms`` (the same behind a spin kernel:
card time alone, and host microseconds per call).  The old build and the
kernel alternate old, new, new, old, on preallocated outputs, and the old
build's result is compared with the kernel's (max |d area|, n_cross
mismatches).  Prints one line per measurement and writes all of them, with
the card's name and power limit, to ``--out`` as JSON (by default
``subzero_tpu_torch/_build/clip_bench.json``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as smoke

P = ctypes.c_void_p


def load(source, with_lanes):
    from subzero_tpu_torch.kernels import clip as kclip

    so, _, log = kclip.compile_source(Path(source))
    fn = ctypes.CDLL(str(so)).clip_stats_f32
    fn.argtypes = ([P, P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_double]
                   + ([ctypes.c_int] if with_lanes else []) + [P] * 5)
    fn.restype = ctypes.c_int
    for r in smoke.ptxas_instances(log):
        if "double" not in r["name"]:
            smoke.log(f"[ptxas] {Path(source).name} {r['name']}: "
                      f"{r.get('regs')} registers, {r.get('spill_st')} B "
                      f"spill stores, {r.get('spill_ld')} B spill loads")
    return fn


def shapes():
    import torch

    from subzero_tpu_torch.state import state_from_polygons

    polys, vel, lx = smoke.lattice(smoke.N_FLOES)
    cfg = smoke.lattice_config(smoke.N_FLOES, lx, periodic=True,
                               dtype="float32")
    state = state_from_polygons(polys, 0.5, cfg, velocities=vel)
    p, q, fw, wq = smoke.main_path_pairs(state, cfg)
    yield "main-path overlap", p.contiguous(), q.contiguous(), False
    yield "main-path wall", fw, wq, True
    del p, q, fw, wq

    def dev(pair):
        return (torch.from_numpy(x).to("cuda", torch.float32) for x in pair)

    yield ("wide 64x64", *dev(smoke.random_pairs(4096, 64, 64,
                                                 seed=4096 + 128)), False)
    yield ("default capacity", *dev(smoke.random_pairs(
        163840, 64, 64, seed=11, nv_range=(10, 30))), False)


def timed(fn):
    """{"ms": cuda_ms, "card_ms": card alone, "host_us": per call}."""
    card, host = smoke.card_ms(fn)
    return {"ms": smoke.cuda_ms(fn), "card_ms": card, "host_us": host}


def main() -> int:
    import torch

    from subzero_tpu_torch.geometry.clip_integral import eps_scale
    from subzero_tpu_torch.kernels import clip as kclip

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", help="source with the earlier C interface")
    ap.add_argument("--sweep", action="store_true",
                    help="time every lane group that fits")
    ap.add_argument("--out",
                    default=str(kclip.BUILD_DIR / "clip_bench.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_clip_bench: CUDA is not available", file=sys.stderr)
        return 2

    new = load(kclip.SOURCE, True)
    old = load(args.old, False) if args.old else None
    stream = torch.cuda.current_stream().cuda_stream
    eps = eps_scale(torch.float32)
    rows = []
    for name, a, b, diff in shapes():
        n, vp, vq = a.shape[0], a.shape[1], b.shape[1]
        g0 = kclip.lane_group(n, vp, vq)
        bound, by, nbytes, flops = smoke.clip_bound_ms(a, b)
        edge_pairs = float((smoke.real_edges(a) * smoke.real_edges(b)).sum())

        def runner(fn, lanes, a=a, b=b):
            outs = (torch.empty(n, device="cuda"),
                    torch.empty(n, 2, device="cuda"),
                    torch.empty(n, 2, device="cuda"),
                    torch.empty(n, dtype=torch.int32, device="cuda"))
            ptrs = [o.data_ptr() for o in outs]
            lane_arg = [] if lanes is None else [lanes]

            def go():
                err = fn(a.data_ptr(), b.data_ptr(), n, vp, vq, int(diff),
                         eps, *lane_arg, *ptrs, stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            return go, outs

        run_new, out_new = runner(new, g0)
        run_new()
        row = {"shape": name, "B": n, "Vp": vp, "Vq": vq, "G": g0,
               "bound_ms": bound, "bound_by": by, "bytes": nbytes,
               "flops": flops, "real_edge_pairs": edge_pairs}
        if old is not None:
            run_old, out_old = runner(old, None)
            run_old()
            torch.cuda.synchronize()
            d_area = float((out_old[0] - out_new[0]).abs().max())
            bad = int((out_old[3] != out_new[3]).sum())
            t = [timed(run_old), timed(run_new), timed(run_new),
                 timed(run_old)]
            row["old"] = {"runs": [t[0], t[3]], "max_abs_d_area": d_area,
                          "n_cross_mismatches": bad}
            row["new"] = [t[1], t[2]]
            for k, unit in (("ms", "ms"), ("card_ms", "ms"),
                            ("host_us", "us")):
                smoke.log(f"[bench] {name} {k}: old {t[0][k]:.4f}/"
                          f"{t[3][k]:.4f} {unit}, new (G={g0}) "
                          f"{t[1][k]:.4f}/{t[2][k]:.4f} {unit}, ratio "
                          f"{(t[0][k] + t[3][k]) / (t[1][k] + t[2][k]):.2f}x")
            smoke.log(f"[bench] {name}: old max|d area| {d_area:.3e}, "
                      f"n_cross mismatches {bad}")
        else:
            row["new"] = [timed(run_new)]
        ms = sum(r["ms"] for r in row["new"]) / len(row["new"])
        card = sum(r["card_ms"] for r in row["new"]) / len(row["new"])
        smoke.log(f"[bench] {name} B={n} Vp={vp} Vq={vq}: new (G={g0}) "
                  f"{ms:.4f} ms, {card:.4f} ms card alone; bound "
                  f"{bound:.4f} ms ({by}), share {bound / ms:.1%} and "
                  f"{bound / card:.1%}")

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
                  f"{edge_pairs:.4g} real edge pairs, "
                  f"{loops * 1e6 / max(edge_pairs, 1):.4f} ns each "
                  f"(both passes)")
        del flat_a, flat_b
        if args.sweep:
            row["sweep"] = {}
            for g in (1, 2, 4, 8, 16, 32):
                if kclip.tile_bytes(g, vp, vq, 4) > kclip.SMEM_LIMIT:
                    continue
                row["sweep"][g] = timed(runner(new, g)[0])
                smoke.log(f"[sweep] {name} G={g:2d}: "
                          f"{row['sweep'][g]['card_ms']:.4f} ms card alone, "
                          f"{row['sweep'][g]['ms']:.4f} ms")
        rows.append(row)
        del a, b
        torch.cuda.empty_cache()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card_name = smi.stdout.strip().splitlines()[0]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card_name, "rows": rows},
                                         indent=1))
    smoke.log(f"[bench] {card_name}; written {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
