"""Row-gather probes that bound the SpMM (K7) on one NVIDIA GPU —
counterpart of `scripts/spmm_probe.py`.

    python -m embiggen_tpu_torch.scripts.spmm_probe

prints one JSON line per probe: gathered `rows_per_s`, `gbytes_per_s` and
`ms` per call (CUDA events, mean over 5 calls after one warm-up), with the
card's name. The plain probes gather with PyTorch and sum the rows, in
chunks of 2^22 rows so the gathered block stays at 2 GB:
  torch_gather        x[idx].sum(0), x f32 [1M, 128], idx [20M]
  torch_gather_bf16   the same with bf16 rows
  torch_gather_2par   two half-size gathers
  torch_gather_4par   four quarter-size gathers
  torch_gather_wide   D = 256 rows, half as many
  torch_gather_sorted sorted indices
  cuda_tile_gather    P1: sums of tiles of 256 rows, idx [2M]
  cuda_table_gather   P2: sums of blocks of 8192 rows from a [8192, 128]
                      table that stays in L2, idx [2M]
  torch_small_table_gather  the plain gather of P2's table
"""
from __future__ import annotations

import json
from typing import Callable, Dict, List

import torch

from ..ops.gather_probe import P1_TILE, P2_BLOCK, table_gather_sums, tile_gather_sums

N, D, E = 1_000_000, 128, 20_000_000
E_SMALL = 2_000_000
TABLE = 8192
CHUNK = 1 << 22


def time_ms(fn: Callable[[], object], reps: int = 5) -> float:
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


def gather_sum(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx].sum(0) in chunks of CHUNK rows, summed in float32."""
    out = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    for i in range(0, idx.shape[0], CHUNK):
        out += x[idx[i:i + CHUNK]].sum(dim=0, dtype=torch.float32)
    return out


def record(name: str, rows: int, d: int, bytes_per_elt: int, ms: float) -> Dict:
    return {"probe": name, "rows_per_s": rows / (ms / 1e3),
            "gbytes_per_s": rows * d * bytes_per_elt / (ms / 1e3) / 1e9, "ms": ms}


def run(device: torch.device, reps: int = 5) -> List[Dict]:
    """Every probe on `device` (a CUDA device), from a fixed seed."""
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((N, D), generator=gen, device=device)
    idx = torch.randint(0, N, (E,), generator=gen, device=device, dtype=torch.int32)
    out = [record("torch_gather", E, D, 4, time_ms(lambda: gather_sum(x, idx), reps))]
    xb = x.to(torch.bfloat16)
    out.append(record("torch_gather_bf16", E, D, 2,
                      time_ms(lambda: gather_sum(xb, idx), reps)))
    del xb
    for parts in (2, 4):
        q = E // parts
        out.append(record(f"torch_gather_{parts}par", E, D, 4, time_ms(
            lambda: sum(gather_sum(x, idx[i * q:(i + 1) * q]) for i in range(parts)),
            reps)))
    x_wide = torch.randn((N // 2, 256), generator=gen, device=device)
    idx_wide = torch.randint(0, N // 2, (E // 2,), generator=gen, device=device,
                             dtype=torch.int32)
    out.append(record("torch_gather_wide", E // 2, 256, 4,
                      time_ms(lambda: gather_sum(x_wide, idx_wide), reps)))
    del x_wide, idx_wide
    idx_sorted = torch.sort(idx).values
    out.append(record("torch_gather_sorted", E, D, 4,
                      time_ms(lambda: gather_sum(x, idx_sorted), reps)))
    del idx_sorted
    idx_small = idx[:E_SMALL].contiguous()
    out.append(record("cuda_tile_gather", E_SMALL // P1_TILE * P1_TILE, D, 4,
                      time_ms(lambda: tile_gather_sums(x, idx_small), reps)))
    tbl = torch.randn((TABLE, D), generator=gen, device=device)
    idx_tbl = torch.randint(0, TABLE, (E_SMALL,), generator=gen, device=device,
                            dtype=torch.int32)
    out.append(record("cuda_table_gather", E_SMALL // P2_BLOCK * P2_BLOCK, D, 4,
                      time_ms(lambda: table_gather_sums(tbl, idx_tbl), reps)))
    out.append(record("torch_small_table_gather", E_SMALL, D, 4,
                      time_ms(lambda: gather_sum(tbl, idx_tbl), reps)))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("spmm_probe: no CUDA device; the probes run only on "
                         "an NVIDIA GPU.")
    device = torch.device("cuda")
    card = torch.cuda.get_device_name(device)
    for rec in run(device):
        print(json.dumps({**rec, "device": card}), flush=True)


if __name__ == "__main__":
    main()
