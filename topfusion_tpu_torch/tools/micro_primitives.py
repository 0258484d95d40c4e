"""Microbenchmarks of the scatter / sort / gather primitives that
dominate the block pipeline, in their PyTorch forms (port of
``scripts/micro_primitives.py``): the JAX script's rows at its sizes.

  * scatter-min: ``scatter_reduce_(..., "amin")``;
  * scatter-set / scatter-add with JAX's ``mode="drop"``: ``index_put_`` /
    ``index_add_`` into a buffer with one extra row, which the result
    leaves out;
  * sort, argsort (stable, as ``jnp.argsort``), int32 cumsum;
  * gathers: ``index_select``, ``torch.gather`` along the band;
  * the one-hot band gather as the ``einsum`` it is in JAX, in float32
    at full precision (TF32 off).

Inputs from ``torch.Generator`` seed 0.  Rows and columns as
``tools/profile_stages.py``'s.

Usage:  python3 -m topfusion_tpu_torch.tools.micro_primitives [--device cpu]
"""

from __future__ import annotations

import argparse
import sys


def run(device, n: int = 10):
    """Every row; returns the Timer."""
    import torch

    from .timing import Timer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int64).to(device)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(device)

    HW = 480 * 640
    N524, N131, N2M, CAP = 524288, 131072, 1 << 21, 131072
    idx_524k = randint(0, HW, (N524,))
    val_524k = randint(0, 1 << 30, (N524,)).to(torch.int32)
    idx_131k = idx_524k[:N131]
    val3_2m = randn(N2M, 3)
    idx_2m = randint(0, CAP, (N2M,))

    def scatter_min(i, v):
        out = torch.full((HW,), 2 ** 30, dtype=torch.int32, device=device)
        return out.scatter_reduce_(0, i, v, "amin")

    def scatter_set_drop(i, v):
        out = torch.zeros((CAP + 1, 3), device=device)  # the extra row takes the drops
        out.index_put_((torch.where((i >= 0) & (i < CAP), i, CAP),), v)
        return out[:CAP]

    def scatter_add_drop(i, v):
        out = torch.zeros((HW + 1,), device=device)
        out.index_add_(0, torch.where((i >= 0) & (i < HW), i, HW), v)
        return out[:HW]

    timer = Timer(device, n=n, width=48)
    print(timer.header())
    timer.row("scatter-min 524k -> 307k img", scatter_min, idx_524k, val_524k)
    timer.row("scatter-min 131k -> 307k img", scatter_min, idx_131k, val_524k[:N131])
    timer.row("scatter-set 2M -> 131k (compaction)", scatter_set_drop, idx_2m, val3_2m)
    timer.row("scatter-set 524k -> 131k", scatter_set_drop, idx_2m[:N524], val3_2m[:N524])
    timer.row("scatter-add 524k scalar -> 307k", scatter_add_drop, idx_524k,
              val_524k.to(torch.float32))

    keys600k = randint(0, 1 << 30, (614400,)).to(torch.int32)
    keys150k = keys600k[:153600]
    keys2m = randint(0, 1 << 30, (N2M,)).to(torch.int32)
    timer.row("sort 600k i32", lambda x: torch.sort(x).values, keys600k)
    timer.row("sort 150k i32", lambda x: torch.sort(x).values, keys150k)
    timer.row("sort 2M i32", lambda x: torch.sort(x).values, keys2m)
    timer.row("sort 600k i32 + argsort payload", lambda x: torch.argsort(x, stable=True), keys600k)
    cum = lambda x: torch.cumsum(x, 0, dtype=torch.int32)  # noqa: E731
    timer.row("cumsum 2M i32", cum, (keys2m > 0).to(torch.int32))
    timer.row("cumsum 600k i32", cum, (keys600k > 0).to(torch.int32))

    pool = randn(65536 + 1, 512)
    slots4k = randint(0, 65536, (4096,))
    timer.row("gather 4k x 512-rows from 128MB pool", lambda p, s: p.index_select(0, s), pool, slots4k)
    tbl307k = randn(HW, 8)
    idxhw = randint(0, HW, (HW,))
    timer.row("gather 307k x 8 from 9.8MB", lambda t, i: t.index_select(0, i), tbl307k, idxhw)
    timer.row("gather 307k scalar from 1.2MB img", lambda t, i: t.reshape(-1).index_select(0, i),
              tbl307k[:, 0].contiguous(), idxhw)
    b16 = randn(HW // 64, 64, 8)
    i16 = randint(0, 64, (HW // 64, 64))
    timer.row("rowwise take_along 64-band 307k",
              lambda t, i: torch.gather(t, 1, i[..., None].expand(-1, -1, t.shape[2])), b16, i16)
    oh = torch.nn.functional.one_hot(i16, 64).to(torch.float32)
    timer.row("one-hot band gather 307k (bmm 4800x64x64x8)",
              lambda o, t: torch.einsum("bqk,bkc->bqc", o, t), oh, b16)
    return timer


def main(argv=None) -> int:
    from ..utils.device_info import entry_device, nvidia_smi_name_power
    from .timing import add_device_arg

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    device = entry_device(args.device)
    if device.type == "cuda":
        print(nvidia_smi_name_power())
    run(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
