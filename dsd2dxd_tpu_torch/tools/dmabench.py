"""P1: the copy and launch floor of the fused kernel's scaffold, on the card.

Counterpart of the JAX package's ``tools/dmabench.py`` (its Pallas probe
``_probe`` and its main). The probe is K1's scaffold with no DSP: a grid
of (block, row) CUDA blocks, each owning a window of u32 words of one row
(a channel) and storing the last ``k_sub`` words it loaded as f32 of their
int32 bits (``csrc/probes.cu``, ``dma_probe_kernel``). The modes keep the
TPU tool's names:

  noop      no input read; store j to the streamed output
  noflush   load the window; every block writes the same output block
  dma       load the window with its halo overlap, stream the output
  halo0     load the window without the overlap
  contig    windows relaid out beforehand (outside the timed region) into
            one contiguous slab per block
  bspec     the same slabs, brought to shared memory by one bulk copy
            (``cp.async.bulk``, the TMA's 1-D copy, on an mbarrier)
  relayout  the halo replication alone, in torch ops (no kernel), as the
            JAX tool prices it in XLA

``Geometry`` carries what the TPU tool derived from its block: words per
block B, halo words H (the overlap), values stored per block ``k_sub`` and,
for contig/bspec, the words each block loads from its slab (``row_words``,
H + B by default: one channel's window; the JAX probe's ``lanes8`` in the
parity tests). ``dma_probe_reference`` is the plain version; noflush's
returns every block's values (the card's blocks run in no order, so each
element of its output block is some block's; the TPU's is the last's).

    python -m dsd2dxd_tpu_torch.tools.dmabench [--blocks 2048,2560,10240]
        [--tile-mib 16] [--reps 8] [--modes ...]
    python -m dsd2dxd_tpu_torch.tools.dmabench --device cpu

The default blocks are K1's own (``fused.block_out_for`` x frame bytes over
every pure ÷2^k chain) plus one 4x the largest, each with the largest
overlap K1 loads at that block (rounded up to 16 bytes). Per mode it
prints µs per 16 KiB-equivalent of per-channel input, the multiple of
DSD512 real time and the GB/s moved, as the TPU tool does, over
``STAGED_TILES`` tiles staged on the card.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import sys
import threading
from dataclasses import dataclass

import numpy as np
import torch

from dsd2dxd_tpu_torch import kernels
from dsd2dxd_tpu_torch.filters.design import get_chain
from dsd2dxd_tpu_torch.formats.dsd_types import (
    DsdRate,
    FilterType,
    check_filter_choice,
)
from dsd2dxd_tpu_torch.ops import fused
from dsd2dxd_tpu_torch.tools import DSD512_HZ, STAGED_TILES, round_robin
from dsd2dxd_tpu_torch.utils.device import card_label, resolve_device

MODES = ("noop", "noflush", "dma", "halo0", "contig", "bspec", "relayout")
KERNEL_MODES = MODES[:-1]
_CODE = {m: i for i, m in enumerate(KERNEL_MODES)}
CHANNELS = 2

# Kernel launches per mode (incremented right after each successful
# launch, and nowhere else).
LAUNCHES = {m: 0 for m in KERNEL_MODES}
_launch_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _launch_lock:
        for m in LAUNCHES:
            LAUNCHES[m] = 0


@dataclass(frozen=True)
class Geometry:
    block_words: int     # B: words per block
    halo_words: int      # H: the overlap each window carries
    k_sub: int           # values stored per block and row
    row_words: int = 0   # contig/bspec: words each block loads; 0 = H + B

    @property
    def win(self) -> int:
        return self.halo_words + self.block_words

    @property
    def load_words(self) -> int:
        return self.row_words or self.win


def relayout(x: torch.Tensor, g: Geometry, n_blocks: int) -> torch.Tensor:
    """Halo-replicate (rows, H + n*B) words -> (n, rows * (H + B)): block
    i's slab is the windows [i*B, i*B + H + B) of every row, one after
    the other. One slice + cat + transpose, as the JAX tool's XLA pass
    (without its 8-row padding)."""
    rows = x.shape[0]
    b, h = g.block_words, g.halo_words
    if h > b:
        raise ValueError(f"halo of {h} words is longer than the block")
    lead = x[:, :n_blocks * b].reshape(rows, n_blocks, b)[:, :, :h]
    body = x[:, h:h + n_blocks * b].reshape(rows, n_blocks, b)
    w3 = torch.cat([lead, body], dim=2)
    return w3.transpose(0, 1).reshape(n_blocks, rows * g.win)


def load_words(mode: str, g: Geometry) -> int:
    """Words each block of a mode loads into shared memory."""
    return {"noop": 0, "halo0": g.block_words, "contig": g.load_words,
            "bspec": g.load_words}.get(mode, g.win)


def _check(x: torch.Tensor, mode: str, g: Geometry, rows: int,
           n_blocks: int) -> None:
    if mode not in KERNEL_MODES:
        raise ValueError(f"no probe kernel for mode {mode!r}")
    if x.dtype != torch.int32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"want contiguous 2-D int32 words, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if mode in ("contig", "bspec"):
        want = (n_blocks, rows * g.win)
        if g.load_words > g.win:
            raise ValueError("row_words * rows exceeds the slab")
    else:
        want = (rows, g.halo_words + n_blocks * g.block_words)
    if mode != "noop" and tuple(x.shape) != want:
        raise ValueError(f"mode {mode} wants words {want}, got "
                         f"{tuple(x.shape)}")
    if not 1 <= g.k_sub <= (load_words(mode, g) or g.k_sub):
        raise ValueError(f"k_sub {g.k_sub} outside 1..{load_words(mode, g)}")


def dma_probe_reference(x: torch.Tensor, mode: str, g: Geometry, rows: int,
                        n_blocks: int) -> torch.Tensor:
    """Plain version of the probe. `x`: (rows, H + n*B) int32 words, or
    for contig/bspec the relaid (n, rows * (H + B)) slabs. Returns
    (rows, n * k_sub) f32; noflush (rows, n, k_sub), every block's."""
    _check(x, mode, g, rows, n_blocks)
    j = torch.arange(g.k_sub, device=x.device)
    i = torch.arange(n_blocks, device=x.device).unsqueeze(1)
    if mode == "noop":
        return j.to(torch.float32).repeat(rows, n_blocks)
    if mode in ("contig", "bspec"):
        c = torch.arange(rows, device=x.device).view(rows, 1, 1)
        col = c * g.load_words + (g.load_words - g.k_sub) + j
        vals = x[i.unsqueeze(0).expand(rows, -1, -1), col]
    else:
        end = g.block_words if mode == "halo0" else g.win
        vals = x[:, (i * g.block_words + end - g.k_sub + j)]
    vals = vals.to(torch.float32)  # (rows, n, k_sub)
    return vals if mode == "noflush" else vals.reshape(rows, -1)


def _params(mode: str, g: Geometry, rows: int, n_blocks: int,
            x: torch.Tensor) -> kernels.DmaParams:
    p = kernels.DmaParams()
    p.in_row_words = x.shape[1] if mode not in ("contig", "bspec") else 0
    p.rows = rows
    p.n_blocks = n_blocks
    p.block_words = g.block_words
    p.halo_words = g.halo_words
    p.k_sub = g.k_sub
    p.row_words = g.load_words
    p.slab_words = rows * g.win
    p.smem_bytes = 4 * load_words(mode, g)
    return p


def dma_probe_cuda(x: torch.Tensor, mode: str, g: Geometry, rows: int,
                   n_blocks: int) -> torch.Tensor:
    """Launch the probe on the current stream; same contract as
    ``dma_probe_reference`` except noflush, whose (rows, k_sub) output
    block holds, element by element, some block's value. Raises if the
    launch fails."""
    _check(x, mode, g, rows, n_blocks)
    if mode == "bspec" and (g.load_words % 4 or g.win % 4
                            or x.data_ptr() % 16):
        raise ValueError("bspec's bulk copy wants 16-byte aligned slabs "
                         "(row_words and H + B multiples of 4 words)")
    lib = kernels.load()
    shape = (rows, g.k_sub) if mode == "noflush" else (rows,
                                                      n_blocks * g.k_sub)
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    p = _params(mode, g, rows, n_blocks, x)
    with kernels.launch_device(x.device) as (stream, dev):
        rc = lib.dsd2dxd_dma_probe(x.data_ptr(), out.data_ptr(),
                                   _CODE[mode], ctypes.byref(p), stream, dev)
    if rc != 0:
        raise RuntimeError(f"dma probe ({mode}) launch failed: CUDA error "
                           f"{rc}")
    with _launch_lock:
        LAUNCHES[mode] += 1
    return out


def dma_probe(x: torch.Tensor, mode: str, g: Geometry, rows: int,
              n_blocks: int) -> torch.Tensor:
    """A CUDA tensor launches the kernel (or raises); a CPU tensor runs
    the plain version."""
    if x.is_cuda:
        return dma_probe_cuda(x, mode, g, rows, n_blocks)
    if x.device.type == "cpu":
        return dma_probe_reference(x, mode, g, rows, n_blocks)
    raise ValueError(f"no probe on {x.device}")


def k1_blocks() -> list[tuple[int, int]]:
    """(block bytes, halo bytes) of K1's blocks over every pure ÷2^k
    chain: block_out_for x frame bytes, with the largest overlap K1 loads
    at that block (its window beyond the block's own bytes) rounded up
    to 16 bytes; then one 4x the largest block with the largest overlap."""
    halo: dict[int, int] = {}
    for filt in FilterType:
        for rate in DsdRate:
            for out in (88200, 176400, 352800, 705600, 1411200):
                try:
                    check_filter_choice(filt, rate, out)
                except ValueError:
                    continue
                chain = get_chain(filt, rate, out)
                if fused.decimation(chain) is None:
                    continue
                bo = fused.block_out_for(chain)
                lay = fused.kernel_layout(chain,
                                          fused.chain_halo_bytes(chain), bo)
                bb = bo * lay.frame_bytes
                over = -(-(lay.n_load_bytes - bb) // 16) * 16
                halo[bb] = max(halo.get(bb, 0), over)
    top = max(halo)
    halo[4 * top] = max(halo.values())
    return sorted(halo.items())


def geometry(block_bytes: int, halo_bytes: int) -> Geometry:
    """The card's geometry for a block: B and H in words, one stored
    value per input word (k_sub = B), each slab row one channel's window."""
    if block_bytes % 4 or halo_bytes % 4:
        raise ValueError("block and halo must be whole u32 words")
    return Geometry(block_words=block_bytes // 4,
                    halo_words=halo_bytes // 4, k_sub=block_bytes // 4)


def moved_bytes(mode: str, g: Geometry, rows: int, n_blocks: int) -> int:
    """Bytes a mode moves for n_blocks blocks of every row: its window
    loads (relayout: the slab read and written) and its output stores."""
    per_block = 2 * g.win if mode == "relayout" else load_words(mode, g)
    out = 0 if mode in ("noflush", "relayout") else g.k_sub
    return 4 * rows * n_blocks * (per_block + out)


def bound_bytes(mode: str, g: Geometry, rows: int, n_blocks: int) -> int:
    """Bytes the mode's function must move, each input read once and
    each output written once: the input words it loads (the padded
    stream, the stream without its halo lead, or the slabs) and its
    output (noflush: one block; relayout: the slabs)."""
    stream = rows * (g.halo_words + n_blocks * g.block_words)
    slabs = n_blocks * rows * g.win
    out = rows * n_blocks * g.k_sub
    return 4 * {"noop": out,
                "noflush": stream + rows * g.k_sub,
                "dma": stream + out,
                "halo0": rows * n_blocks * g.block_words + out,
                "contig": slabs + out,
                "bspec": slabs + out,
                "relayout": stream + slabs}[mode]


def _cpu_run(modes) -> dict:
    """The plain versions at a tiny size: shapes and checksums."""
    g = geometry(512, 48)
    n_blocks = 4
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(
        0, 2 ** 32, (CHANNELS, g.halo_words + n_blocks * g.block_words),
        dtype=np.uint32).view(np.int32))
    xr = relayout(x, g, n_blocks)
    res = {}
    for m in modes:
        out = (xr if m == "relayout" else dma_probe(
            xr if m in ("contig", "bspec") else x, m, g, CHANNELS, n_blocks))
        res[m] = tuple(out.shape)
        print(f"  {m:8s} plain version on the CPU: out {tuple(out.shape)} "
              f"sum {float(out.double().sum()):.6g} (no times)")
    return res


def main(argv=None) -> dict:
    """Run the sweep; returns {block bytes: {"geometry", "n_blocks",
    "tile", "ms" {mode: [per-tile ms per rep]}, "med_ms" {mode: ms}}}."""
    ap = argparse.ArgumentParser(prog="dmabench", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--blocks", default=None,
                    help="block bytes per channel, comma separated "
                         "(default: K1's blocks and one 4x larger)")
    ap.add_argument("--tile-mib", type=int, default=16)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--device", default=None,
                    help="cuda device (default: the first card); 'cpu' "
                         "runs the plain versions at a tiny size, untimed")
    args = ap.parse_args(argv)
    modes = [m for m in args.modes.split(",") if m]
    bad = [m for m in modes if m not in MODES]
    if bad:
        ap.error(f"unknown modes {bad}")
    dev = resolve_device(args.device)  # None: the card, or raise
    if dev.type == "cpu":
        return {"cpu": _cpu_run(modes)}
    k1 = dict(k1_blocks())
    blocks = ([int(b) for b in args.blocks.split(",")] if args.blocks
              else sorted(k1))
    label = card_label().splitlines()[0]
    rng = np.random.default_rng(0)
    results = {}
    for bb in blocks:
        g = geometry(bb, k1.get(bb, max(k1.values())))
        tile = (args.tile_mib * 1024 * 1024 // bb) * bb
        n_blocks = tile // bb
        xs = [torch.from_numpy(rng.integers(
            0, 2 ** 32, (CHANNELS, g.halo_words + n_blocks * g.block_words),
            dtype=np.uint32).view(np.int32)).to(dev)
            for _ in range(STAGED_TILES)]
        # contig/bspec consume the relaid slabs, built once per tile
        # outside the timed region (relayout prices that pass)
        xrs = ([relayout(x, g, n_blocks) for x in xs]
               if {"contig", "bspec"} & set(modes) else [])

        def run(mode, _g=g, _n=n_blocks, _xs=xs, _xrs=xrs):
            if mode == "relayout":
                return lambda: [relayout(x, _g, _n) for x in _xs]
            src = _xrs if mode in ("contig", "bspec") else _xs
            return lambda: [dma_probe_cuda(x, mode, _g, CHANNELS, _n)
                            for x in src]

        times = round_robin({m: run(m) for m in modes}, args.reps)
        med = {m: statistics.median(times[m]) / STAGED_TILES for m in modes}
        n16 = tile / 16384
        print(f"-- block={bb} B/ch ({g.block_words} words, halo "
              f"{g.halo_words}, k_sub={g.k_sub}, n_blocks={n_blocks}/tile, "
              f"{STAGED_TILES} tiles of {tile} B/ch x {CHANNELS}) "
              f"[{label}] --")
        for m in modes:
            us = med[m] * 1e3 / n16
            xrt = tile * 8 / DSD512_HZ / (med[m] * 1e-3)
            gbs = moved_bytes(m, g, CHANNELS, n_blocks) / (med[m] * 1e-3) / 1e9
            print(f"  {m:8s} {us:8.4f} us/16KiB  [{xrt:8.0f}x DSD512RT]"
                  f"  ~{gbs:7.1f} GB/s moved")
        results[bb] = {"geometry": g, "n_blocks": n_blocks, "tile": tile,
                       "ms": times, "med_ms": med}
        del xs, xrs
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
