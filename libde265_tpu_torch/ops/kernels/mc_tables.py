"""K1 and K5: the MC tile tables (csrc/mc_tables.cu).

K1 inserts one frame's stride-4 tiles into the persistent table at a DPB
slot, in place; it replaces
libde265_tpu/ops/pallas/mc_tables.py:update_tile_table_pallas. K5 builds
fresh tables for a stack of R reference frames (the tile-column
decoder's per-frame build); it replaces build_tile_table_pallas. Both
share one block body. `update_tile_table` / `build_tile_tables` launch
the CUDA kernels for CUDA tensors and run `update_tile_table_plain` /
`build_tile_tables_plain`, the same functions in plain PyTorch, for CPU
tensors; their `.launches` count kernel launches.
"""
import ctypes

import torch

from ... import _build
from ..mc_tile import build_tile_table_c, build_tile_table_y, tile_rows

# K1 and K5 take the same arguments: ..., slot (K1) or R (K5), elem_bytes
_ARGS = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 9 \
    + [ctypes.c_void_p]


def _geometry(table, padded, T):
    P, Hp, Wp = padded.shape
    nty = (Hp - T + 4) // 4
    ntx = (Wp - T + 4) // 4
    nty_p = -(-nty // 8) * 8
    return P, Hp, Wp, nty, ntx, nty_p


def update_tile_table_plain(table, padded, slot, T):
    """table: (NSLOTS*nty_p*ntx, P*T*T) uint8 (8-bit streams) or int16
    (9 to 12 bits); padded: (P, Hp, Wp) int16 edge-padded planes; writes
    slot `slot` in place and returns table."""
    P = padded.shape[0]
    tiles = tile_rows(padded, T, table.dtype)       # (P, nty_p, ntx, T*T)
    rows = tiles.permute(1, 2, 0, 3).reshape(-1, P * T * T)
    n = rows.shape[0]
    table[slot * n:(slot + 1) * n] = rows
    return table


def update_tile_table(table, padded, slot, T):
    """Kernel wrapper: same contract as update_tile_table_plain."""
    if table.device.type == "cpu" and padded.device.type == "cpu":
        return update_tile_table_plain(table, padded, slot, T)
    P, Hp, Wp, nty, ntx, nty_p = _geometry(table, padded, T)
    if table.device.type != "cuda" or padded.device != table.device:
        raise ValueError("update_tile_table: table and padded must be on "
                         "the same CUDA device")
    if table.dtype not in (torch.uint8, torch.int16) \
            or padded.dtype != torch.int16:
        raise TypeError(f"update_tile_table: want a uint8 or int16 table "
                        f"and int16 planes, got {table.dtype} / "
                        f"{padded.dtype}")
    if (P, T) not in ((1, 16), (2, 8)):
        raise ValueError(f"update_tile_table: unsupported P={P}, T={T}")
    if table.dim() != 2 or table.shape[1] != P * T * T:
        raise ValueError(f"update_tile_table: table {tuple(table.shape)} "
                         f"rows must be {P * T * T} elements")
    slot = int(slot)
    if slot < 0 or (slot + 1) * nty_p * ntx > table.shape[0]:
        raise ValueError(f"update_tile_table: slot {slot} outside a table "
                         f"of {table.shape[0]} rows")
    if not (table.is_contiguous() and padded.is_contiguous()):
        raise ValueError("update_tile_table: tensors must be contiguous")
    _launch(table, padded, slot, T)
    update_tile_table.launches += 1
    return table


def _launch(table, padded, slot, T):
    P, Hp, Wp, nty, ntx, nty_p = _geometry(table, padded, T)
    fn = _build.kernel_fn("k1_update_tile_table", _ARGS)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = fn(table.data_ptr(), padded.data_ptr(), P, T, Hp, Wp, nty, nty_p,
             ntx, slot, table.element_size(), stream)
    _build.check_launch("k1_update_tile_table", err)


update_tile_table.launches = 0


def build_tile_table_plain(padded, T, out_dtype=torch.uint8):
    """padded: (R, P, Hp, Wp) int16 edge-padded stack of plane groups
    (P = 1 luma with T = 16, P = 2 [Cb, Cr] with T = 8). Returns a fresh
    (R*nty_p*ntx, P*T*T) table of out_dtype whose rows interleave the P
    planes' tiles ([Cb 64 | Cr 64]); the ROWPAD rows hold zeros."""
    build = build_tile_table_y if T == 16 else build_tile_table_c
    return torch.cat([build(padded[:, p], out_dtype)
                      for p in range(padded.shape[1])], dim=1)


def build_tile_tables_plain(py, pc, out_dtype=torch.uint8):
    """py: (R, Hp, Wp) int16 edge-padded luma stack; pc: (R, 2, Hpc, Wpc)
    int16 edge-padded [Cb, Cr] pairs (ops/mc_tile.pad_refs). Returns the
    fresh tables (ty (R*nty_p*ntx, 256), tc2 (R*ntyc_p*ntxc, 128))."""
    return (build_tile_table_plain(py[:, None], 16, out_dtype),
            build_tile_table_plain(pc, 8, out_dtype))


def build_tile_tables(py, pc, out_dtype=torch.uint8):
    """Kernel wrapper: same contract as build_tile_tables_plain; one K5
    launch for the luma stack, one for the [Cb|Cr] pairs."""
    if py.device.type == "cpu" and pc.device.type == "cpu":
        return build_tile_tables_plain(py, pc, out_dtype)
    dev = py.device
    if dev.type != "cuda" or pc.device != dev:
        raise ValueError("build_tile_tables: py and pc must be on the same "
                         "CUDA device")
    if py.dtype != torch.int16 or pc.dtype != torch.int16:
        raise TypeError(f"build_tile_tables: want int16 planes, got "
                        f"{py.dtype} / {pc.dtype}")
    if out_dtype not in (torch.uint8, torch.int16):
        raise TypeError(f"build_tile_tables: out_dtype {out_dtype}")
    if py.dim() != 3 or pc.dim() != 4 or pc.shape[1] != 2 \
            or pc.shape[0] != py.shape[0] or py.shape[0] < 1:
        raise ValueError(f"build_tile_tables: want (R,Hp,Wp) and "
                         f"(R,2,Hpc,Wpc), R >= 1, got {tuple(py.shape)} "
                         f"and {tuple(pc.shape)}")
    if not (py.is_contiguous() and pc.is_contiguous()):
        raise ValueError("build_tile_tables: tensors must be contiguous")
    out = []
    for padded, T in ((py[:, None], 16), (pc, 8)):
        out.append(_launch_build(padded, T, out_dtype))
        build_tile_tables.launches += 1
    return tuple(out)


def _launch_build(padded, T, out_dtype):
    """One K5 launch: (R, P, Hp, Wp) int16 -> fresh (R*nty_p*ntx, P*T*T)
    table."""
    R, P, Hp, Wp = padded.shape
    nty = (Hp - T + 4) // 4
    ntx = (Wp - T + 4) // 4
    nty_p = -(-nty // 8) * 8
    table = torch.empty((R * nty_p * ntx, P * T * T), dtype=out_dtype,
                        device=padded.device)
    fn = _build.kernel_fn("k5_build_tile_table", _ARGS)
    stream = torch.cuda.current_stream(padded.device).cuda_stream
    err = fn(table.data_ptr(), padded.data_ptr(), P, T, Hp, Wp, nty, nty_p,
             ntx, R, table.element_size(), stream)
    _build.check_launch("k5_build_tile_table", err)
    return table


build_tile_tables.launches = 0
