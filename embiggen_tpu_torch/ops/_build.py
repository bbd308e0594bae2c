"""Build, load and launch the port's CUDA kernels.

The sources in `embiggen_tpu_torch/csrc/` expose a plain C interface, so they
compile with nvcc alone (seconds; sources that include PyTorch's headers take
minutes), one nvcc per source, all started together, and link into one shared
library that is loaded with ctypes. Nothing here runs at import: the first
launch builds the library, and `build()` does so explicitly. The library's
name carries a hash of the sources, flags and defines, so an edited source is
rebuilt and never served stale. A variant built with extra defines (such as
PHASE_CLOCK, which compiles in per-phase clock stamps) is a library of
its own beside the default one.

Every wrapper dispatches on the device of the tensors it is given: a CPU
tensor goes to the kernel's plain PyTorch version, a CUDA tensor to the
kernel, and any other device raises. There is no fallback from one to the
other.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Compiles in clock64() stamps per phase of K3 (`csrc/skipgram.cu`), K9
# (`csrc/walks2.cu`) and K11 (`csrc/cbow.cu`), written to the buffer each
# launcher takes; without it that argument is ignored.
PHASE_CLOCK = ("-DEBT_PHASE_CLOCK",)

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_U32, _U64, _F32 = ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_float
_SIGNATURES = {
    "ebt_first_order_walks": (
        (_P, _P, _P, _P, _P, _P, _P, _I64, _I32, _U64, _U32, _P), _I32),
    "ebt_first_order_batch": (
        (_P,) * 5 + (_I32, _I64, _I64, _I64, _I32, _I32, _I32, _P, _P, _U64, _U32, _P), _I32),
    "ebt_node_draws": ((_P, _I64, _I64, _P, _I64, _U64, _U32, _P), _I32),
    "ebt_skipgram_nce": (
        (_P,) * 13 + (_I64, _I32, _I32, _I32, _I32, _F32, _P), _I32),
    "ebt_scatter_add_rows": ((_P, _P, _P, _P, _I64, _I32, _P), _I32),
    "ebt_mean_combine": ((_P, _P, _P, _F32, _I64, _I32, _I32, _P), _I32),
    "ebt_skipgram_combine": ((_P,) * 8 + (_F32, _I64, _I32, _P), _I32),
    "ebt_csr_edge_ids": ((_P, _P, _P, _P, _I64, _I32, _I32, _P, _P, _P), _I32),
    "ebt_edge_minibatch": (
        (_P,) * 6 + (_I32, _I32, _I64, _I64, _I64, _I32, _I32, _P, _P, _P, _U64, _U32, _P),
        _I32),
    "ebt_csr_spmm": ((_P,) * 7 + (_I64, _I32, _I32, _P, _P, _I64, _I32, _P, _P), _I32),
    "ebt_csr_spmm_combine": ((_P, _P, _I64, _P, _P, _P, _I32, _I32, _P), _I32),
    "ebt_edge_metrics": ((_P, _P, _P, _P, _I64, _I32, _P, _P), _I32),
    "ebt_tile_gather_sums": ((_P, _P, _I64, _I64, _I32, _P, _P), _I32),
    "ebt_table_gather_sums": ((_P, _P, _I64, _I64, _I32, _P, _P), _I32),
    "ebt_ell_walks": (
        (_P,) * 5 + (_F32, _F32, _I32, _I32, _P, _P, _I64, _I32, _F32, _F32, _U64, _U32, _P, _P),
        _I32),
    "ebt_exact_walks": (
        (_P,) * 9 + (_I64, _I32, _I32, _F32, _F32, _F32, _F32, _U64, _U32, _P), _I32),
    "ebt_rejection_walks": (
        (_P,) * 6 + (_I64, _I32, _F32, _F32, _I32, _U64, _U32, _P), _I32),
    "ebt_cbow_update": ((_P,) * 13 + (_I64, _I32, _I32, _I32, _I32, _F32, _P), _I32),
    "ebt_siamese_batch": (
        (_P, _P, _P, _P, _I32, _I64, _I64, _I32, _P, _P, _P, _P, _P, _U64, _U32, _P), _I32),
    "ebt_line_batch": (
        (_P, _P, _P, _I32, _I64, _I64, _I32, _I32, _I32, _P, _P, _P, _U64, _U32, _P), _I32),
    "ebt_walklets_update": ((_P,) * 12 + (_I64, _I64) + (_I32,) * 5 + (_P,), _I32),
    "ebt_cooc_count": ((_P, _I64, _I32, _P, _I32, _P, _P), _I32),
    "ebt_cooc_scan": ((_P, _I64, _P, _P, _P), _I32),
    "ebt_cooc_scatter": (
        (_P, _I64, _I32, _P, _I32, _I32, _P, _P, _P, _I64, _I64, _P, _P), _I32),
    "ebt_cooc_sort": (
        (_P, _P, _P, _I64, _I32, _P, _P, _P, _P, _P, _I32, _I32, _P, _P, _P, _P, _P), _I32),
    "ebt_cooc_write": (
        (_P,) * 5 + (_I64, _I32) + (_P,) * 3 + (_I32, _I32) + (_P,) * 6, _I32),
    "ebt_glove_gradients": ((_P,) * 14 + (_I64, _I32, _F32, _P), _I32),
    "ebt_glove_node_update": ((_P,) * 8 + (_I64, _P, _I64, _I32, _F32, _P), _I32),
    "ebt_glove_context_update": ((_P, _P, _P, _I64, _I32, _F32, _P), _I32),
    "ebt_min_plus_step": ((_P,) * 6 + (_I64, _I32, _I32, _P), _I32),
    "ebt_hll_singletons": ((_I64, _I32, _I32, _U32, _P, _P), _I32),
    "ebt_hll_hop": ((_P, _P, _P, _I64, _P, _I64, _I64, _I32, _I32, _P, _P, _I64, _I32, _P, _P),
                    _I32),
    "ebt_hll_hop_merge": ((_P, _P, _I64, _P, _I64, _P, _P, _I64, _I32, _P), _I32),
    "ebt_hll_ball": ((_P, _P, _I64, _I32, _I32, _U32, _I32, _P, _I64, _P), _I32),
    "ebt_hll_edge_features": ((_P, _I32, _I32, _P, _P, _I64, _F32, _P, _P), _I32),
    "ebt_sketch_candidates": ((_P, _P, _P, _I64, _I32, _I32, _F32, _I32, _P), _I32),
    "ebt_sketch_race_step": ((_P, _P, _P, _I32) + (_P,) * 4 + (_I64, _I32, _I32, _P), _I32),
    "ebt_halo_spmm": ((_P,) * 5 + (_I32, _P, _P, _P, _I64, _I32, _I32, _P), _I32),
    "ebt_owned_gather": ((_P, _I64, _I64, _P, _I64, _I32, _P, _P), _I32),
    "ebt_owned_count": ((_P, _I64, _I64, _P, _I64, _P), _I32),
    "ebt_owned_scatter": ((_P, _I64, _I64, _P, _P, _I64, _I32, _P, _P, _F32, _P), _I32),
    "ebt_sddmm": ((_P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _P), _I32),
    "ebt_edge_chunk": ((_P, _P, _P, _I32, _I64, _I64, _I64, _P, _P, _P, _P), _I32),
    "ebt_error_string": ((_I32,), ctypes.c_char_p),
}

# Kernel launches per wrapper since the last reset: each wrapper adds one per
# launch of its kernel and nowhere else, so a run can show that it went
# through the kernels.
LAUNCHES: Dict[str, int] = dict.fromkeys(
    ("first_order_walks", "nce_negatives", "first_order_batch", "skipgram_nce_update",
     "mean_scatter", "mean_combine", "skipgram_mean_combine",
     "csr_edge_ids", "edge_prediction_mini_batch", "spmm", "spmm_combine", "edge_metrics",
     "tile_gather_sums", "table_gather_sums", "ell_walks", "ell_walks_typed",
     "rejection_walks", "exact_walks",
     "cbow_update", "siamese_mini_batch", "line_mini_batch", "walklets_update",
     "cooccurrences", "glove_gradients", "glove_node_update", "glove_context_update",
     "min_plus_step", "hll_registers",
     "khop_sketches", "khop_merge", "sketch_hop1", "sketch_hop2", "edge_sketch_features",
     "sketch_candidates", "sketch_race_step",
     "halo_spmm", "halo_spmm_backward", "sharded_spmm", "owned_gather", "owned_count",
     "owned_scatter", "sddmm", "edge_chunk", "chunk_mask"), 0,
)

# While a `timed_launches()` block runs: a CUDA event pair recorded on the
# stream around each counted launch, by counter. None outside such a block.
_EVENTS: Optional[Dict[str, List[Tuple[torch.cuda.Event, torch.cuda.Event]]]] = None

_libs: Dict[Tuple[str, ...], ctypes.CDLL] = {}


@contextlib.contextmanager
def timed_launches():
    """Record a CUDA event pair around every counted launch inside the block
    (not inside a CUDA graph capture). Yields {counter: [(start, end), ...]},
    to be read after the block and a synchronize: on a stream kept busy,
    `start.elapsed_time(end)` is the kernel's own device time."""
    global _EVENTS
    events: Dict[str, List[Tuple[torch.cuda.Event, torch.cuda.Event]]] = {}
    _EVENTS = events
    try:
        yield events
    finally:
        _EVENTS = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _sources() -> Tuple[Path, ...]:
    return tuple(sorted(CSRC.glob("*.cu")))


def digest(flags: Sequence[str], paths: Iterable[Path]) -> str:
    """16 hex digits of a sha1 of the flags and of each file's name and bytes."""
    h = hashlib.sha1(" ".join(flags).encode())
    for path in paths:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def compile_shared(so: Path, compile_to: Callable[[Path], None], signatures,
                   force: bool = False) -> ctypes.CDLL:
    """Load the shared library `so`, compiling it first when it is missing (or
    with `force`): `compile_to(tmp)` writes it to a temporary file beside
    `so`, which is then renamed to `so`, so that processes building it at
    once each load a whole library. `signatures` maps each function's name
    to its ctypes (argtypes, restype)."""
    if force or not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        try:
            compile_to(tmp)
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for fn_name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def library_path(defines: Tuple[str, ...] = ()) -> Path:
    return BUILD_DIR / (f"libembiggen_tpu_torch_"
                        f"{digest(NVCC_FLAGS + tuple(defines), sorted(CSRC.iterdir()))}.so")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("No CUDA toolkit found: nvcc is needed to build "
                           "the kernels.")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _run_all(cmds) -> str:
    """Run the commands at once; return their joined output, or raise with
    it if one failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, cwd=CSRC) for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(" ".join(c) + "\n" + o for c, o in zip(cmds, outs))
    failed = [c[-1] for c, p in zip(cmds, procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    return log


def build(force: bool = False, defines: Tuple[str, ...] = ()) -> float:
    """Compile the kernels (unless an up-to-date library exists, or `force`)
    and load them. Returns the seconds spent. nvcc's output, including the
    per-kernel register and shared-memory report, goes to
    `_build/build.log` (`build_<defines>.log` for a variant)."""
    t0 = time.perf_counter()
    defines = tuple(defines)
    name = "build" + "".join("_" + d.lstrip("-D").lower() for d in defines)

    def compile_to(tmp: Path) -> None:
        objs = [tmp.with_name(f"{tmp.name}.{p.stem}.o") for p in _sources()]
        try:
            log = _run_all([[_nvcc(), *NVCC_FLAGS, *defines, "-c", "-o", str(o), str(p)]
                            for o, p in zip(objs, _sources())])
            log += _run_all([[_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                              *map(str, objs)]])
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
        (BUILD_DIR / f"{name}.log").write_text(log)

    _libs[defines] = compile_shared(library_path(defines), compile_to, _SIGNATURES, force)
    return time.perf_counter() - t0


def library(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    if tuple(defines) not in _libs:
        build(defines=defines)
    return _libs[tuple(defines)]


def launch(counter: Optional[str], fn_name: str, device: torch.device, *args,
           defines: Tuple[str, ...] = ()) -> None:
    """Call one C launcher on `device`'s current stream (appended as the last
    argument), raise if the launch failed, and count it under `counter`
    (None: a measurement's launch, counted nowhere). On the current device
    (the usual case) it takes the raw stream handle alone, without a device
    context or a Stream object: a step launches several kernels, and those
    lookups took most of a launcher's host time."""
    lib = _libs.get(defines) or library(defines)
    timed = _EVENTS is not None and counter is not None
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    with contextlib.nullcontext() if index == current else torch.cuda.device(index):
        if timed:
            pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            pair[0].record()
        err = getattr(lib, fn_name)(*args, torch._C._cuda_getCurrentRawStream(index))
        if timed:
            pair[1].record()
            _EVENTS.setdefault(counter, []).append(pair)
    if err != 0:
        raise RuntimeError(
            f"{fn_name} failed to launch: CUDA error {err} "
            f"({lib.ebt_error_string(err).decode()})")
    if counter is not None:
        LAUNCHES[counter] += 1


def is_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; any other device
    raises. This is the wrappers' whole dispatch rule."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"No kernel or plain version for device {t.device}.")


def check(t: Optional[torch.Tensor], name: str, dtype: torch.dtype,
          shape: Optional[Tuple[int, ...]], device: torch.device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` (None:
    any) on `device` — what the kernels take."""
    if t is None:
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}.")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}.")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}.")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous.")


def clock_shares(clocks: torch.Tensor, phases: Tuple[str, ...]) -> Dict[str, float]:
    """{phase: share of the total} from a PHASE_CLOCK launch's cycles
    [rows, len(phases) + 1], the last column each row's total."""
    total = clocks.sum(0).double().cpu()
    return {name: float(total[i] / total[-1]) for i, name in enumerate(phases)}


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def draw_seed(generator: torch.Generator) -> Tuple[int, int]:
    """(64-bit Philox key, 32-bit counter offset) drawn from the fit's
    generator, so kernel draws follow its seed."""
    seed, offset = torch.randint(
        0, 2**62, (2,), generator=generator, device=generator.device,
    ).tolist()
    return seed, offset & 0xFFFFFFFF
