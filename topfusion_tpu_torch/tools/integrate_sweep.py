"""What bounds the column integrate kernel on the card: a sweep over
builds of ``csrc/integrate.cu`` at the bench configuration.

    python3 -m topfusion_tpu_torch.tools.integrate_sweep [int16,float32]

run from the root of the repository on a machine with one NVIDIA GPU and
``nvcc``.  It builds the source as it is and in variants made by textual
replacement, into ``topfusion_tpu_torch/_build/sweep/``, and prints for
each the registers the compiler reports, whether the pool is bit-equal
to the plain version's, and the kernel's time from the profiler (median
of REPEATS launches, L2 flushed before each, and L2 warm):

  * ``base`` at 1, 2, 4, 8 and 16 entries per CTA (64 threads each); the
    variants below run at the wrapper's own entries per CTA;
  * ``regs32`` / ``regs40``: ``__launch_bounds__`` that cap the registers
    to 32 / 40 (occupancy);
  * ``operator_div``: the four divisions per voxel through the division
    operator, in place of the source's ``divide()`` (the same quotients,
    with the operator's range check and a reciprocal each);
  * ``fastdiv_proj`` / ``fastdiv_all``: the two divisions of the
    projection, then all four, as ``__fdividef``; and ``nogather``: no
    depth load.  These three change the result ON PURPOSE (not bit-equal,
    never shipped): they show what the time is made of.

Every case is timed twice, in opposite orders.  It also prints the static
operation count of the column kernels from ``cuobjdump -sass``.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

from ..ops.cuda import integrate as wrapper
from ..ops.cuda.build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, find_nvcc
from ..ops.depth import depth_to_meters
from ..ops.tsdf_block import allocate_from_depth, integrate_blocks, visible_blocks
from ..utils.device_info import nvidia_smi_name_power
from .bench_config import bench_config, with_plain_integrate

REPEATS = 30
KERNEL = "integrate_columns_kernel"
DECL = f"__global__ void {KERNEL}("
ENTRIES_PER_CTA = (1, 2, 4, 8, 16)


def replaced(src: str, *pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"the source no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def variants(src: str) -> dict:
    proj = ("divide(x, safe_z, rz)", "divide(y, safe_z, rz)")
    fuse = ("divide(eta, p.mu, r_mu)", "divide(tsdf * w + new_f, w1, refined_reciprocal(w1))")

    def with_division(calls, form):
        """``divide(a, b, r)`` -> ``form`` of a and b, for each call."""
        pairs = []
        for call in calls:
            a, b = (x.strip() for x in call[len("divide("):].split(",")[:2])
            pairs.append((call, form.format(a=a, b=b)))
        return pairs

    return {
        "base": src,
        "operator_div": replaced(src, *with_division(proj + fuse, "(({a}) / ({b}))")),
        "regs32": replaced(src, (DECL, f"__global__ void __launch_bounds__(256, 8) {KERNEL}(")),
        "regs40": replaced(src, (DECL, f"__global__ void __launch_bounds__(256, 6) {KERNEL}(")),
        "fastdiv_proj": replaced(src, *with_division(proj, "__fdividef({a}, {b})")),
        "fastdiv_all": replaced(src, *with_division(proj + fuse, "__fdividef({a}, {b})")),
        "nogather": replaced(src, ("d[k] = __ldg(depth + pixel);",
                                   "d[k] = z[k] + (float)pixel * 1e-9f;")),
    }


def build(name: str, src: str, out: Path):
    """(entry point, the compiler's register lines of the column kernels)."""
    cu, so = out / f"{name}.cu", out / f"lib{name}.so"
    cu.write_text(src)
    res = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{res.stderr}")
    lines = (res.stdout + res.stderr).splitlines()
    regs = [re.sub(r"ptxas info\s*: ", "", f"{lines[i + 1].strip()}; {lines[i + 2].strip()}")
            for i, line in enumerate(lines[:-2]) if "Function properties" in line and KERNEL in line]
    return wrapper.bind_entry_point(ctypes.CDLL(str(so))), regs, so


def sass_counts(so: Path) -> str:
    """Static SASS operation counts of each column kernel in a library."""
    res = subprocess.run(["cuobjdump", "-sass", str(so)], capture_output=True, text=True)
    if res.returncode != 0:
        return f"cuobjdump failed: {res.stderr.strip()}"
    out, name, ops = [], None, []

    def flush():
        if name and KERNEL in name:
            dt = re.search(r"kernelILi(\d)E", name)
            out.append(f"pool dtype code {dt.group(1) if dt else '?'}: {len(ops)} SASS operations, "
                       f"{ops.count('MUFU')} MUFU (one per division), "
                       f"{ops.count('LDG')} LDG, {ops.count('STG')} STG")

    for line in res.stdout.splitlines():
        if "Function :" in line:
            flush()
            name, ops = line, []
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
        if m:
            ops.append(m.group(1))
    flush()
    return "\n".join(out)


def main() -> int:
    import chip_smoke as cs  # the timers live there

    from ..io.synthetic import orbit_trajectory
    from ..models.block_pipeline import BlockPipeline

    if not torch.cuda.is_available():
        print("integrate_sweep: no CUDA device", file=sys.stderr)
        return 1
    dtypes = sys.argv[1].split(",") if len(sys.argv) > 1 else ["int16", "float32"]
    device = torch.device("cuda", 0)
    print(nvidia_smi_name_power())
    out = BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    built = {}
    for name, src in variants((CSRC_DIR / "integrate.cu").read_text()).items():
        fn, regs, so = build(name, src, out)
        built[name] = fn
        print(f"{name}: " + " | ".join(regs))
        if name == "base":
            print(sass_counts(so))

    poses = orbit_trajectory(cs.FRAMES, max_angle_deg=3.0, max_shift=0.03, seed=1)
    frames = cs.render_frames(bench_config(), poses, device)
    for dtype in dtypes:
        cfg = with_plain_integrate(bench_config(dtype))
        pipe = BlockPipeline(cfg, device)
        state, _, _ = cs.run(pipe, pipe.init(), frames[:3])
        cam, tc, bm = cfg.camera, cfg.tsdf, cfg.blockmap
        T = torch.as_tensor(poses[3], dtype=torch.float32, device=device)
        raw = depth_to_meters(frames[3], cfg.preproc.max_sensor_depth)
        m, _ = allocate_from_depth(state.block_map(), cam, tc, bm, T, raw)
        vis = visible_blocks(m, cam, tc, bm, T, depth=raw)
        num_entries = vis[0].shape[0]

        def fresh():
            return m._replace(tsdf=m.tsdf.clone(), weight=m.weight.clone())

        plain, _ = integrate_blocks(fresh(), cam, tc, bm, T, raw, vis)
        cases = []
        for name, fn in built.items():
            for per_cta in ENTRIES_PER_CTA if name == "base" else (wrapper.COLUMN_ENTRIES_PER_CTA,):
                plan = wrapper.LaunchPlan("column", -(-num_entries // per_cta), 64 * per_cta, per_cta)
                cases.append((f"{name}, {per_cta} per CTA", fn, plan))
        rows = {}
        for order in (cases, cases[::-1]):
            for label, fn, plan in order:
                mk = fresh()
                wrapper.launch_kernel(fn, mk, cam, tc, bm, T, raw, vis, plan)
                torch.cuda.synchronize()
                equal = torch.equal(mk.tsdf, plain.tsdf) and torch.equal(mk.weight, plain.weight)
                mt = fresh()

                def call():
                    wrapper.launch_kernel(fn, mt, cam, tc, bm, T, raw, vis, plan)

                cold = cs.kernel_event_ms(call, REPEATS, KERNEL)
                warm = cs.kernel_event_ms(call, REPEATS, KERNEL, flush_l2=False)
                rows.setdefault(label, []).append((equal, cold, warm))
        for label, r in rows.items():
            print(f"{dtype:9s} {label:24s} bit-equal {str(all(x[0] for x in r)):5s} "
                  f"L2 flushed {r[0][1] * 1e3:6.2f} {r[1][1] * 1e3:6.2f} us   "
                  f"L2 warm {r[0][2] * 1e3:6.2f} {r[1][2] * 1e3:6.2f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
