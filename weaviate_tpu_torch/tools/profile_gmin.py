"""Stage-level profiler for the headline gmin search on the card (twin of
`tools/profile_gmin.py`): three timing modes over one shared setup, and
the two store layouts of the group-min scan that the component mode
compares with K1, as hand-written Hopper kernels (`csrc/gmin_layouts.cu`,
K1's resident-tile scan with a depth-major filler):

  K4 `nt_scores`  the store pre-transposed to [G, D, ncols], so the
                  product reads it as it lies (no transpose on the way in);
  K5 `c4_scores`  gc groups side by side, [G/gc, D, gc*ncols] in a
                  tile-wise interleave of width scg (`interleave`).

Each wrapper launches its kernel for CUDA tensors with K1's tile plan for
the store's groups (`layout_plan`), counts the launch (`nt_launches`,
`c4_launches[gc]`) and raises if the depth has no plan (D > 6208, where the
reference has no limit) or the launch fails; for CPU tensors it runs its
plain torch version (`*_reference`).

Modes (``--mode``):

  loop (default)  ITERS launches of each stage on one stream, each
                  iteration's query perturbed by a carry taken from the
                  previous output (q + carry, carry = 1e-9 * out[0]), so
                  the iterations form one dependent chain with no host
                  sync between them, timed by CUDA events around the
                  chain: the mean device time per iteration, including
                  any gap the host leaves between launches when it
                  enqueues slower than the card runs. Stages:
                    kernel        group_min_scores (K1)
                    kernsel       kernel + exact top-RG group selection
                    topk_strided  full gmin_topk, strided-row gather
                    topk_block    full gmin_topk, contiguous block gather
                    legacy        index/gpu._search_full, rescore_r=128

  component       Single-call medians (REPS after one warm-up, each
                  call between two CUDA events) of the search components
                  and the two layout kernels:
                    kernel / select / topk / legacy   as above
                    kernel_nt     K4 over the transposed store
                    kernel_c2/c4  K5 with 2 / 4 groups per slice

  gather          Isolates the candidate-rescore gather stage:
                    search_gmin       the staged search entry (packed [B, 2k])
                    kernel / select   as above
                    gather_strided    strided-member gather
                    gather_blocked    contiguous [ncols, G*D] block rows
                    rescore_nogather  dense-slab upper bound (no gather)

Group selection is the port's exact `smallest_k` (the TPU profiler used
approx_min_k). On the CPU (``--device cpu``) every stage runs its plain
torch version and the times are the CPU's.

    python -m weaviate_tpu_torch.tools.profile_gmin [--mode loop|component|gather]
        [--device cuda|cpu] [N] [B] [ITERS]

Each stage prints ``name ms/batch qps``; the last line is one JSON object
with every stage's ms.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import time
from types import SimpleNamespace

import torch

from weaviate_tpu_torch.device import resolve_device
from weaviate_tpu_torch.ops import _kernels, gmin_scan
from weaviate_tpu_torch.ops.gmin_scan import G
from weaviate_tpu_torch.ops.topk import smallest_k

D = 128
K = 10
REPS = 5
# K5's interleave width in the component mode: the width the profiler has
# always used, so its layout and its earlier K5 times stay comparable
INTERLEAVE_WIDTH = 128

# launches of the CUDA kernels by nt_scores and by c4_scores (keyed by gc),
# never the CPU path
nt_launches = 0
c4_launches: dict[int, int] = {}

_lib = None


def _layouts_lib():
    global _lib
    if _lib is None:
        lib = _kernels.load("gmin_layouts")
        vp, ll, ci, cf = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        lib.nt_scores_launch.argtypes = [vp, vp, vp, vp, vp, ll, ll, ll, ci, cf, ci, ci, ci, vp]
        lib.c4_scores_launch.argtypes = [vp, vp, vp, vp, vp, ll, ll, ll, ci, ci, ll, cf, ci, ci,
                                         ci, vp]
        lib.nt_scores_launch.restype = lib.c4_scores_launch.restype = ctypes.c_int
        lib.gmin_layouts_error_string.argtypes = [ctypes.c_int]
        lib.gmin_layouts_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# -- the two layouts ----------------------------------------------------------

def transpose_store(store3: torch.Tensor) -> torch.Tensor:
    """[G, ncols, D] store view -> [G, D, ncols] contiguous (K4's layout)."""
    return store3.transpose(1, 2).contiguous()


def interleave(store3t: torch.Tensor, bias2: torch.Tensor, gc: int,
               scg: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's layout: [G, D, ncols] store and [G, ncols] bias -> store4 [G/gc,
    D, gc*ncols] and bias4 [G/gc, gc*ncols]. Tile i of slice si is gc
    consecutive width-scg blocks, block t holding group si*gc+t's columns
    i*scg .. (i+1)*scg. scg must divide ncols."""
    g, d, ncols = store3t.shape
    view = store3t.reshape(g // gc, gc, d, ncols // scg, scg)
    s4 = view.permute(0, 2, 3, 1, 4).reshape(g // gc, d, ncols * gc).contiguous()
    b4 = (bias2.reshape(g // gc, gc, ncols // scg, scg)
          .permute(0, 2, 1, 3).reshape(g // gc, ncols * gc).contiguous())
    return s4, b4


# -- K4 and K5: plain versions and wrappers -----------------------------------

def nt_scores_reference(q: torch.Tensor, store3t: torch.Tensor, bias2: torch.Tensor,
                        alpha: float) -> torch.Tensor:
    """Plain torch version of K4: per slice, the f32 product of the
    bf16-rounded operands, then bias + alpha * qx and a running min (as
    gmin_scan.group_min_scores_reference)."""
    qb = q.to(torch.bfloat16).float()
    out = torch.full((q.shape[0], store3t.shape[2]), float("inf"), dtype=torch.float32,
                     device=q.device)
    for gi in range(store3t.shape[0]):
        qx = qb @ store3t[gi].to(torch.bfloat16).float()
        out = torch.minimum(out, bias2[gi][None, :] + alpha * qx)
    return out


def c4_scores_reference(q: torch.Tensor, store4: torch.Tensor, bias4: torch.Tensor,
                        alpha: float, scg: int, gc: int) -> torch.Tensor:
    """Plain torch version of K5: per slice and member t, the f32 product
    of the bf16-rounded query with member t's columns (bf16-rounded), then
    bias + alpha * qx and a running min. The reference's one product per
    slice computes the same dot products; taking a member at a time keeps
    the [B, gc*ncols] intermediate out of memory."""
    nslice, d, width = store4.shape
    ncols = width // gc
    qb = q.to(torch.bfloat16).float()
    out = torch.full((q.shape[0], ncols), float("inf"), dtype=torch.float32, device=q.device)
    for si in range(nslice):
        x = store4[si].view(d, ncols // scg, gc, scg)
        bias = bias4[si].view(ncols // scg, gc, scg)
        for t in range(gc):
            qx = qb @ x[:, :, t, :].reshape(d, ncols).to(torch.bfloat16).float()
            out = torch.minimum(out, bias[:, t, :].reshape(ncols)[None, :] + alpha * qx)
    return out


def _check_operands(name: str, q: torch.Tensor, **tensors: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {q.device}")
    for arg, t in {"q": q, **tensors}.items():
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{arg} must be a contiguous torch.float32 tensor on {q.device}")


def layout_plan(d: int, groups: int) -> gmin_scan.ResidentPlan:
    """K1's resident-tile plan for a store of `groups` slices at depth d
    (every slice is scanned, as in the reference); raises past D 6208,
    where no tile fits."""
    plan = gmin_scan.resident_plan(d, groups)
    if plan is None:
        raise gmin_scan.no_plan_error(d)
    return plan


def _launch(fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise _kernels.launch_error("gmin_layouts kernel launch failed", rc,
                                    _layouts_lib().gmin_layouts_error_string(rc).decode())


def nt_scores(q: torch.Tensor, store3t: torch.Tensor, bias2: torch.Tensor,
              alpha: float) -> torch.Tensor:
    """[B, D] f32 queries x [g, D, ncols] f32 transposed store -> [B, ncols]
    group-min scores over all g slices (K4). On a CUDA tensor this launches
    the Hopper kernel with layout_plan(D, g) and raises if D has no plan or
    the launch fails; on a CPU tensor it runs nt_scores_reference."""
    global nt_launches
    if q.device.type == "cpu":
        return nt_scores_reference(q, store3t, bias2, alpha)
    _check_operands("nt_scores", q, store3t=store3t, bias2=bias2)
    b, d = q.shape
    g, d2, ncols = store3t.shape
    if d2 != d or tuple(bias2.shape) != (g, ncols) or g > G:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, store3t {tuple(store3t.shape)}, "
                         f"bias2 {tuple(bias2.shape)} (at most {G} slices)")
    plan = layout_plan(d, g)
    # the C entry point launches on the current device: enter q's
    with torch.cuda.device(q.device):
        out = torch.empty((b, ncols), dtype=torch.float32, device=q.device)
        if b == 0 or ncols == 0:
            return out
        lib = _layouts_lib()
        _launch(lib.nt_scores_launch, q.data_ptr(), store3t.data_ptr(), bias2.data_ptr(),
                gmin_scan.query_scratch(q, plan).data_ptr(), out.data_ptr(), b, ncols, d, g,
                float(alpha), plan.scg, int(d % 4 == 0 and q.data_ptr() % 16 == 0),
                int(store3t.data_ptr() % 16 == 0),
                torch.cuda.current_stream(q.device).cuda_stream)
    nt_launches += 1
    return out


def c4_scores(q: torch.Tensor, store4: torch.Tensor, bias4: torch.Tensor, alpha: float,
              scg: int, gc: int) -> torch.Tensor:
    """[B, D] f32 queries x store4 [G/gc, D, gc*ncols] f32 and bias4 [G/gc,
    gc*ncols] in the interleave of width scg (`interleave`) -> [B, ncols]
    group-min scores over all groups (K5). On a CUDA tensor this launches
    the Hopper kernel with layout_plan(D, nslice * gc) and raises if D has
    no plan or the launch fails; on a CPU tensor it runs
    c4_scores_reference."""
    if q.device.type == "cpu":
        return c4_scores_reference(q, store4, bias4, alpha, scg, gc)
    _check_operands("c4_scores", q, store4=store4, bias4=bias4)
    b, d = q.shape
    nslice, d2, width = store4.shape
    ncols = width // gc
    if (d2 != d or tuple(bias4.shape) != (nslice, width) or width % gc or scg <= 0
            or ncols % scg or nslice * gc > G):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, store4 {tuple(store4.shape)}, "
                         f"bias4 {tuple(bias4.shape)}, gc {gc}, scg {scg} (scg must divide "
                         f"ncols, at most {G} groups)")
    plan = layout_plan(d, nslice * gc)
    with torch.cuda.device(q.device):
        out = torch.empty((b, ncols), dtype=torch.float32, device=q.device)
        if b == 0 or ncols == 0:
            return out
        lib = _layouts_lib()
        _launch(lib.c4_scores_launch, q.data_ptr(), store4.data_ptr(), bias4.data_ptr(),
                gmin_scan.query_scratch(q, plan).data_ptr(), out.data_ptr(), b, ncols, d,
                nslice, gc, scg, float(alpha), plan.scg,
                int(d % 4 == 0 and q.data_ptr() % 16 == 0), int(store4.data_ptr() % 16 == 0),
                torch.cuda.current_stream(q.device).cuda_stream)
    c4_launches[gc] = c4_launches.get(gc, 0) + 1
    return out


# -- setup and timing ---------------------------------------------------------

def make_data(n: int, b: int, device: torch.device, generator: torch.Generator):
    """The shared SIFT-shape inputs every mode profiles against: n x D and
    b x D standard gaussians from `generator`, made on `device`."""
    store = torch.randn((n, D), generator=generator, device=device)
    norms = torch.sum(store ** 2, dim=1)
    return SimpleNamespace(
        n=n, b=b, dev=device, gen=generator, store=store, norms=norms,
        tombs=torch.zeros(n, dtype=torch.bool, device=device),
        q=torch.randn((b, D), generator=generator, device=device),
        words=torch.zeros(n // 32, dtype=torch.int32, device=device),
        ncols=n // G, alpha=-2.0,
        bias2=norms.view(G, n // G),
        store3=store.view(G, n // G, D),
    )


def _elapsed_ms(dev: torch.device, fn) -> float:
    """ms of fn() on the card between two CUDA events (on the CPU, the host
    clock)."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end)


def _report(name: str, b: int, ms: float) -> None:
    print(f"{name:16s} {ms:9.1f} ms/batch  {b / (ms / 1e3):10.0f} qps", flush=True)


def timed(name: str, b: int, dev: torch.device, fn, *args) -> float:
    """Single-call timing: median of REPS calls after one warm-up -> ms."""
    fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ts = sorted(_elapsed_ms(dev, lambda: fn(*args)) for _ in range(REPS))
    _report(name, b, ts[len(ts) // 2])
    return ts[len(ts) // 2]


def loop_timed(name: str, b: int, iters: int, fn, q: torch.Tensor, *rest) -> float:
    """fn(q, *rest) -> tensor, run `iters` times as one dependent chain
    (see the loop mode above), once to warm up and once timed -> ms per
    iteration."""
    def chain():
        carry = torch.zeros((), dtype=torch.float32, device=q.device)
        for _ in range(iters):
            out = fn(q + carry, *rest)
            carry = 1e-9 * out.ravel()[0].float()
        return carry

    chain()
    if q.device.type == "cuda":
        torch.cuda.synchronize(q.device)
    ms = _elapsed_ms(q.device, chain) / iters
    _report(name, b, ms)
    return ms


# -- modes --------------------------------------------------------------------

def run_component(d) -> dict[str, float]:
    from weaviate_tpu_torch.index.gpu import _search_full

    rg = 64
    plan = gmin_scan.resident_plan(D, G)
    print(f"resident plan S={plan.slices} SCG={plan.scg} N={plan.width} dp={plan.dp} "
          f"smem={plan.smem} (csrc/gmin_resident.cuh)", flush=True)
    out = {"kernel": timed("kernel", d.b, d.dev, gmin_scan.group_min_scores,
                           d.q, d.store3, d.bias2, d.alpha)}
    gmin = gmin_scan.group_min_scores(d.q, d.store3, d.bias2, d.alpha)
    out["select"] = timed("select", d.b, d.dev, smallest_k, gmin, rg)
    del gmin
    out["topk"] = timed("topk", d.b, d.dev, lambda: gmin_scan.gmin_topk(
        d.store, d.norms, d.tombs, d.n, d.q, d.words, False, K, "l2-squared", rg, G))
    out["legacy"] = timed("legacy", d.b, d.dev, lambda: _search_full(
        d.store, d.norms, d.tombs, d.n, d.q, d.words, K, "l2-squared", False,
        rescore_r=128))

    store3t = transpose_store(d.store3)
    out["kernel_nt"] = timed("kernel_nt", d.b, d.dev, nt_scores, d.q, store3t, d.bias2, d.alpha)
    for gc in (2, 4):
        s4, b4 = interleave(store3t, d.bias2, gc, INTERLEAVE_WIDTH)
        print(f"  gc={gc}: scg={INTERLEAVE_WIDTH} slice_width={gc * INTERLEAVE_WIDTH}",
              flush=True)
        out[f"kernel_c{gc}"] = timed(f"kernel_c{gc}", d.b, d.dev, c4_scores,
                                     d.q, s4, b4, d.alpha, INTERLEAVE_WIDTH, gc)
        del s4, b4
    return out


def run_gather(d) -> dict[str, float]:
    rg = 32
    out = {"search_gmin": timed("search_gmin", d.b, d.dev, lambda: gmin_scan.search_gmin(
        d.store, d.norms, d.tombs, d.n, d.q, d.words, False, K, "l2-squared", rg, G))}
    out["kernel"] = timed("kernel", d.b, d.dev, gmin_scan.group_min_scores,
                          d.q, d.store3, d.bias2, d.alpha)
    gmin = gmin_scan.group_min_scores(d.q, d.store3, d.bias2, d.alpha)
    out["select"] = timed("select", d.b, d.dev, lambda x: smallest_k(x, rg)[1], gmin)
    gidx = smallest_k(gmin, rg)[1]
    del gmin

    # the strided-member gather as gmin_topk does it (with its rescore)
    offs = (torch.arange(G, device=d.dev) * d.ncols)[None, None, :]

    def gather_strided(gidx_, q_):
        slots = (gidx_[:, :, None] + offs).reshape(gidx_.shape[0], rg * G)
        return torch.einsum("bd,brd->br", q_, d.store[slots])

    out["gather_strided"] = timed("gather_strided", d.b, d.dev, gather_strided, gidx, d.q)

    # contiguous-block alternative: as if groups were 16 adjacent slots, one
    # gather of rg G*D-wide rows per query from a [ncols, G*D] view
    store_blk = d.store.view(d.ncols, G * D)

    def gather_blocked(gidx_, q_):
        cand = store_blk[gidx_].reshape(gidx_.shape[0], rg * G, D)
        return torch.einsum("bd,brd->br", q_, cand)

    out["gather_blocked"] = timed("gather_blocked", d.b, d.dev, gather_blocked, gidx, d.q)

    # upper bound: no gather at all, the rescore on a dense slab
    slab = torch.randn((d.b, rg * G, D), generator=d.gen, device=d.dev)
    out["rescore_nogather"] = timed("rescore_nogather", d.b, d.dev,
                                    lambda s, q_: torch.einsum("bd,brd->br", q_, s), slab, d.q)
    return out


def run_loop(d, iters: int) -> dict[str, float]:
    from weaviate_tpu_torch.index.gpu import _search_full

    rg = 32
    out = {"kernel": loop_timed(
        "kernel", d.b, iters,
        lambda qq, s3, b2: gmin_scan.group_min_scores(qq, s3, b2, d.alpha),
        d.q, d.store3, d.bias2)}
    out["kernsel"] = loop_timed(
        "kernsel", d.b, iters,
        lambda qq, s3, b2: smallest_k(gmin_scan.group_min_scores(qq, s3, b2, d.alpha),
                                      rg)[1].float(),
        d.q, d.store3, d.bias2)

    def topk(qq, blk):
        return gmin_scan.gmin_topk(d.store, d.norms, d.tombs, d.n, qq, d.words, False, K,
                                   "l2-squared", rg, G, blk)[0]

    out["topk_strided"] = loop_timed("topk_strided", d.b, iters, topk, d.q, None)
    blk = gmin_scan.build_rescore_blocks(d.store)
    out["topk_block"] = loop_timed("topk_block", d.b, iters, topk, d.q, blk)
    del blk
    out["legacy"] = loop_timed(
        "legacy", d.b, iters,
        lambda qq: _search_full(d.store, d.norms, d.tombs, d.n, qq, d.words, K, "l2-squared",
                                False, rescore_r=128)[0],
        d.q)
    return out


def profile(mode: str, d, iters: int) -> dict[str, float]:
    """Run one mode over make_data's inputs -> {stage: ms}."""
    if mode == "component":
        return run_component(d)
    if mode == "gather":
        return run_gather(d)
    return run_loop(d, iters)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="profile_gmin",
        description="stage-level gmin search profiler (see the module docstring for the "
                    "mode catalogue)")
    ap.add_argument("--mode", choices=("loop", "component", "gather"), default="loop",
                    help="timing harness (default: loop, the chained in-stream measurement)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; the CPU runs every stage's plain version")
    ap.add_argument("n", nargs="?", type=int, default=1_048_576,
                    help="store rows, a multiple of 512 (default 1048576)")
    ap.add_argument("b", nargs="?", type=int, default=16384,
                    help="query batch (default 16384)")
    ap.add_argument("iters", nargs="?", type=int, default=8,
                    help="chained iterations, loop mode only (default 8)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device={name} mode={args.mode} N={args.n} B={args.b} D={D} ITERS={args.iters}",
          flush=True)
    d = make_data(args.n, args.b, dev, torch.Generator(device=dev).manual_seed(0))
    stages = profile(args.mode, d, args.iters)
    print(json.dumps({"mode": args.mode, "device": name, "n": args.n, "b": args.b,
                      "stages_ms": stages}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
