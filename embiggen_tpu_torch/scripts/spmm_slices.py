"""Development sweep behind K7's sliced design, on one NVIDIA GPU.

    python -m embiggen_tpu_torch.scripts.spmm_slices [--out FILE]

Builds `spmm_slices.cu` (the sliced kernels, with K7's `csrc/spmm.cu`
included as it is) into a library of its own and, over the Symmetric Normalized Laplacian of
erdos_renyi(1M nodes, 10M edges, seed 0) (20M arcs) with seeded [1M, 128]
f32 features, prints one JSON line per measurement (CUDA events, mean over
10 calls after two warm-ups; each line with the card's name and power
limit):
  in_place       the one-pass kernel reading x in place (the design before
                 the slices), forward and transposed;
  sliced         pack + P passes (SLICED) for slices of 8, 16 and 32 floats,
                 each pass in one launch or in launches over column blocks
                 (the arcs whose columns fall in one block of rows of the
                 slice), with one of the pass kernels: `group` (8 lanes per
                 row; `group_cs` reads the CSR with evict-first loads),
                 `rows` (s / 4 lanes per row) or `tileR` (8 lanes for R
                 rows at once); at s = 8 in one block also with an L2
                 persisting window on the slice being gathered; forward and
                 transposed, the result against in_place;
  csr_cols_only  the forward, the weights read from the scales alone (no
                 vals);
  footprint      one pass (FOOTPRINTS) whose columns are folded onto the
                 first `rows` rows of the slice: gathers per second against
                 the slice's bytes, the L2 budget at which residency breaks;
                 last, at s = 8 with the most persisting L2 set aside and no
                 window marking any line;
  pack           the pack alone, per slice width, a thread per float4 of x
                 (`x` order) or of the packed buffer (`out`), and whether it
                 equals `pack_slices_plain`.
The port keeps the in-place kernel: no sliced product measured here is
faster at this shape (PERF.md). `pack_slices_plain`, `column_block_splits`
and `sliced_spmm_plain` are the sliced product's plain versions, which the
CPU tests hold against K7's plain version and the JAX package.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
from pathlib import Path

import numpy as np
import torch

from ..ops import _build

N_NODES, N_EDGES, DIM = 1_000_000, 10_000_000, 128
REPS = 10
FOOTPRINT_MB = (4, 8, 12, 16, 20, 24, 28, 32, 40, 48, 64)
# (pass kernel, slice width, column blocks) of the sliced products timed,
# (pass kernel, slice width, slice MB) of the footprint sweep, and with
# which settings of the persisting window each is timed.
SLICED = (("group", 8, 1), ("group_cs", 8, 1), ("group", 8, 2), ("group", 16, 1),
          ("group", 16, 2), ("group_cs", 32, 1),
          ("group", 32, 1), ("group", 32, 2), ("group", 32, 4), ("tile2", 8, 1),
          ("tile2", 16, 2), ("rows", 16, 2))
FOOTPRINTS = (("group", 4, (4, 8, 16, 24, 32, 40, 48)), ("group", 8, FOOTPRINT_MB),
              ("group_cs", 8, FOOTPRINT_MB),
              ("group", 16, FOOTPRINT_MB), ("group", 32, FOOTPRINT_MB),
              ("tile2", 16, FOOTPRINT_MB), ("rows", 16, FOOTPRINT_MB))
PERSISTING = {**{key: (False,) for key in SLICED},
              **{key[:2]: (False,) for key in FOOTPRINTS},
              ("group", 8, 1): (False, True), ("group", 8): (False, True),
              ("group", 16): (False, True)}
_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def build_library() -> ctypes.CDLL:
    src = Path(__file__).with_name("spmm_slices.cu")
    h = hashlib.sha1(" ".join(_build.NVCC_FLAGS).encode())
    for path in (src, _build.CSRC / "spmm.cu"):
        h.update(path.read_bytes())
    so = _build.BUILD_DIR / f"libspmm_slices_{h.hexdigest()[:16]}.so"
    if not so.exists():
        _build.BUILD_DIR.mkdir(exist_ok=True)
        log = _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                                str(so), str(src)]])
        (_build.BUILD_DIR / "build_spmm_slices.log").write_text(log)
    lib = ctypes.CDLL(str(so))
    for name, args in (
        ("ebt_csr_spmm", (_P,) * 7 + (_I64, _I32, _I32, _P)),
        ("ebt_pack_slices", (_P, _P, _I64, _I32, _I32, _I32, _P)),
        ("ebt_dev_sliced_pass", (_P,) * 8 + (_I64, _I32, _I32, _I32, _I32, _I32, _P)),
        ("ebt_dev_sliced_rows", (_P,) * 8 + (_I64, _I32, _I32, _I32, _I32, _P)),
        ("ebt_dev_sliced_tile", (_P,) * 8 + (_I64, _I32, _I32, _I32, _I32, _I32, _P)),
        ("ebt_dev_pack_out_order", (_P, _P, _I64, _I32, _I32, _I32, _P)),
        ("ebt_dev_l2_info", (_P,)),
        ("ebt_dev_persist", (_P, _I64, _I64, _P)),
        ("ebt_dev_set_aside", (_I64,)),
    ):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, _I32
    return lib


def pack_slices_plain(x: torch.Tensor, s: int) -> torch.Tensor:
    """x [n, d] -> [ceil(d / s), n, s], slice p holding columns p s ..
    p s + s - 1, zeros past d: what the pack kernel writes."""
    n, d = x.shape
    passes = -(-d // s)
    padded = torch.zeros((n, passes * s), dtype=x.dtype, device=x.device)
    padded[:, :d] = x
    return padded.view(n, passes, s).transpose(0, 1).contiguous()


def column_block_splits(k, blocks: int) -> torch.Tensor:
    """[blocks + 1, n_out] int64: row r's arcs with columns in block b (of
    ceil(n_in / blocks) columns each) are splits[b, r] .. splits[b + 1, r] - 1.
    Raises unless every row's arcs are in column order, which the blocked
    passes need."""
    nb = -(-k.n_in // blocks)
    key = k.rows.long() * blocks + k.cols.long() // nb
    if not bool((key[1:] >= key[:-1]).all()):
        raise ValueError("the rows' arcs are not in column order")
    counts = torch.bincount(key, minlength=k.n_out * blocks).view(k.n_out, blocks)
    starts = k.row_ptr[:-1].long()[:, None] + torch.cat(
        [torch.zeros((k.n_out, 1), dtype=torch.long, device=counts.device),
         counts.cumsum(1)], 1)
    return starts.t().contiguous()


def sliced_spmm_plain(k, x: torch.Tensor, s: int, blocks: int = 1, row_scale=None,
                      col_scale=None) -> torch.Tensor:
    """The sliced product in plain PyTorch, pass by pass as the kernels run
    it: each slice of the packed x through `csr_spmm_plain` over the arcs of
    each column block in turn, the blocks' partial products added."""
    from ..ops.spmm import CSRKernel, csr_spmm_plain

    d = x.shape[1]
    packed = pack_slices_plain(x, s)
    block = k.cols.long() // -(-k.n_in // blocks)
    subs = []
    for b in range(blocks):
        take = block == b
        counts = torch.bincount(k.rows[take].long(), minlength=k.n_out)
        subs.append(CSRKernel(
            row_ptr=torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(torch.int32),
            rows=k.rows[take], cols=k.cols[take], vals=k.vals[take],
            abs_weight_sum=k.abs_weight_sum, sq_weight_sum=k.sq_weight_sum,
            n_out=k.n_out, n_in=k.n_in))
    out = torch.empty((k.n_out, d), dtype=x.dtype, device=x.device)
    for p in range(packed.shape[0]):
        part = csr_spmm_plain(subs[0], packed[p], row_scale, col_scale)
        for sub in subs[1:]:
            part += csr_spmm_plain(sub, packed[p], row_scale, col_scale)
        out[:, p * s:(p + 1) * s] = part[:, :min(s, d - p * s)]
    return out


def time_ms(fn, reps: int = REPS) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run(out_path=None) -> None:
    from ..graph import erdos_renyi
    from ..graph.laplacians import kernel_coo
    from ..ops.spmm import csr_kernel
    from .harness import card_line

    if not torch.cuda.is_available():
        raise SystemExit("spmm_slices: no CUDA device.")
    card = card_line()
    dev = torch.device("cuda")
    lib = build_library()
    stream = torch.cuda.current_stream().cuda_stream
    sink = open(out_path, "w") if out_path else None

    def emit(**row):
        line = json.dumps({"card": card, **row})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")

    def ok(err, what):
        if err != 0:
            raise RuntimeError(f"{what}: CUDA error {err}")

    info = (ctypes.c_int * 4)()
    ok(lib.ebt_dev_l2_info(info), "l2 info")
    l2_bytes, persist_max, window_max, sms = list(info)
    emit(what="device", l2_bytes=l2_bytes, max_persisting_l2_bytes=persist_max,
         max_window_bytes=window_max, sms=sms, torch=torch.__version__,
         cuda=torch.version.cuda)

    graph = erdos_renyi(N_NODES, N_EDGES, seed=0)
    k = csr_kernel(*kernel_coo(graph, "Symmetric Normalized Laplacian"), N_NODES,
                   device=dev)
    del graph
    n, e = N_NODES, k.n_arcs
    rng = np.random.default_rng(24)
    x = torch.from_numpy(rng.standard_normal((n, DIM), dtype=np.float32)).to(dev)
    inv = k.inverse_denominator("mean")
    ref = torch.empty((n, DIM), device=dev)
    got = torch.empty_like(ref)

    def in_place(kk, out, row_scale=None, col_scale=None):
        ok(lib.ebt_csr_spmm(kk.row_ptr.data_ptr(), kk.cols.data_ptr(), kk.vals.data_ptr(),
                            x.data_ptr(), _build.ptr(row_scale), _build.ptr(col_scale),
                            out.data_ptr(), kk.n_out, DIM, 1, stream),
           "in place")

    for name, kk, rs, cs in (("forward", k, inv, None), ("transposed", k.transpose, None, inv)):
        emit(what="in_place", direction=name,
             ms=time_ms(lambda: in_place(kk, ref, rs, cs)))
    in_place(k, ref, inv)

    def persist(ptr, nbytes):
        ok(lib.ebt_dev_persist(ptr, nbytes, min(nbytes, persist_max), stream), "persist")

    def splits_of(kk, blocks):
        return column_block_splits(kk, blocks).to(torch.int32)

    def pass_(variant, kk, starts, ends, xs, out, c0, s, accumulate=0, vals=True,
              cols=None, row_scale=None, col_scale=None):
        args = (starts.data_ptr(), ends.data_ptr(),
                (kk.cols if cols is None else cols).data_ptr(),
                kk.vals.data_ptr() if vals else None, xs.data_ptr(), _build.ptr(row_scale),
                _build.ptr(col_scale), out.data_ptr(), kk.n_out, DIM, c0, s, accumulate)
        if variant.startswith("tile"):
            ok(lib.ebt_dev_sliced_tile(*args, int(variant[4:]), stream), "pass")
        elif variant.startswith("group"):
            ok(lib.ebt_dev_sliced_pass(*args, int(variant == "group_cs"), stream), "pass")
        else:
            ok(lib.ebt_dev_sliced_rows(*args, stream), "pass")

    ref_t = torch.empty_like(ref)
    in_place(k.transpose, ref_t, None, inv)
    for s in (8, 16, 32):
        passes = DIM // s
        packed = torch.empty((passes, n, s), device=dev)
        for order, fn in (("x", lib.ebt_pack_slices), ("out", lib.ebt_dev_pack_out_order)):
            ms = time_ms(lambda: ok(fn(x.data_ptr(), packed.data_ptr(), n, DIM, s, passes,
                                       stream), "pack"))
            emit(what="pack", order=order, s=s, passes=passes, ms=ms,
                 equals_plain=bool(torch.equal(packed, pack_slices_plain(x, s))))
        del packed
    def sliced(variant, s, blocks, persisting):
        passes = DIM // s
        packed = torch.empty((passes, n, s), device=dev)

        def pack():
            ok(lib.ebt_pack_slices(x.data_ptr(), packed.data_ptr(), n, DIM, s, passes,
                                   stream), "pack")
        pack_ms = time_ms(pack)
        for direction, kk, rs, cs, want in (("forward", k, inv, None, ref),
                                            ("transposed", k.transpose, None, inv, ref_t)):
            sp = splits_of(kk, blocks)
            for vals in ((True, False) if direction == "forward" else (True,)):
                def forward():
                    pack()
                    for p in range(passes):
                        if persisting:
                            persist(packed[p].data_ptr(), n * s * 4)
                        for b in range(blocks):
                            pass_(variant, kk, sp[b], sp[b + 1], packed[p], got, p * s, s,
                                  b > 0, vals, row_scale=rs, col_scale=cs)
                    if persisting:
                        persist(None, 0)
                ms = time_ms(forward)
                err = None
                if vals:
                    got.zero_()
                    forward()
                    err = float((got - want).abs().max())
                emit(what="sliced" if vals else "csr_cols_only", variant=variant,
                     direction=direction, s=s, passes=passes, column_blocks=blocks,
                     slice_mb=n * s * 4 / blocks / 2**20, persisting=persisting, ms=ms,
                     pass_ms=(ms - pack_ms) / passes / blocks, pack_ms=pack_ms,
                     max_abs_err_vs_in_place=err)
            del sp
        del packed

    def footprint(variant, s, footprints, persisting):
        packed = torch.empty((1, n, s), device=dev)
        ok(lib.ebt_pack_slices(x.data_ptr(), packed.data_ptr(), n, DIM, s, 1, stream), "pack")
        for mb in footprints:
            rows = (mb << 20) // (4 * s)
            if rows > n:
                continue
            cols = (k.cols % rows).to(torch.int32)

            def one():
                if persisting is True:
                    persist(packed.data_ptr(), rows * s * 4)
                pass_(variant, k, k.row_ptr, k.row_ptr[1:], packed[0], got, 0, s,
                      cols=cols, row_scale=inv)
                if persisting is True:
                    persist(None, 0)
            ms = time_ms(one)
            emit(what="footprint", variant=variant, s=s, rows=rows,
                 slice_mb=rows * s * 4 / 2**20, persisting=persisting, ms=ms,
                 gathers_per_s=e / (ms / 1e3),
                 gathered_gbytes_per_s=e * s * 4 / (ms / 1e3) / 1e9)
            del cols
        del packed

    # The persisting window's set-aside shrinks the L2 left to other
    # accesses while it is set, so every run with it comes last; the very
    # last keeps the whole set-aside in place, with no window, to show that.
    for persisting in (False, True):
        for variant, s, blocks in SLICED:
            if persisting in PERSISTING[(variant, s, blocks)]:
                sliced(variant, s, blocks, persisting)
        for variant, s, footprints in FOOTPRINTS:
            if persisting in PERSISTING[(variant, s)]:
                footprint(variant, s, footprints, persisting)
    ok(lib.ebt_dev_set_aside(persist_max), "set aside")
    footprint("group", 8, FOOTPRINT_MB, "set aside, no window")
    ok(lib.ebt_dev_set_aside(0), "set aside")
    if sink:
        sink.close()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None, help="also write the lines here")
    run(parser.parse_args().out)


if __name__ == "__main__":
    main()
