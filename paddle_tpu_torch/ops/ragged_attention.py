"""Ragged paged attention — the port of ``paddle_tpu/ops/ragged_attention.py``.

``ragged_paged_attention`` reads each slot's live pages of a shared KV pool
through its block table. One function serves decode rows (``q_len = 1``),
ragged causal prefill rows and suffix rows (``kv_len > q_len > 1``), over
pools in the model dtype (kernel K3, the TPU's ``_kernel_body``) or over
int8 / fp8-e4m3 pools with per-(page, row, kv head) f32 scales (kernel K4,
the TPU's ``_kernel_body_quant``; pass ``k_scale`` and ``v_scale``).

Dispatch follows the tensors' device and nothing else:

* CPU tensors take ``ragged_paged_attention_reference``, the plain PyTorch
  version below;
* CUDA tensors launch one of the two hand-written Hopper kernels of
  ``csrc/ragged_paged_attention.cu`` (built with nvcc at first use by
  ``_build.py``), or raise. Nothing sends a CUDA tensor elsewhere. Which
  one is a function of the shapes alone, ``_tile_path``: prefill and
  suffix rows (``q_max > 1``) of a bf16 model at head dims 64 and 128
  take the tile path, ``rpa_tile_kernel`` on the Hopper tile core
  (``rpa_tile_launch``, ``rpa_tile_quant_launch``: wgmma products, an
  asynchronous ring of key tiles gathered through the block table);
  decode rows, head dim 16 and f32 models take ``rpa_kernel`` on CUDA
  cores (``rpa_launch`` for K3, ``rpa_quant_launch`` for K4), which
  splits each slot's keys into page-aligned chunks over its grid when the
  (slot, kv head, query rows) tiles alone would not fill the card several
  times over, and merges the chunks in the same launch; ``_split_plan``
  picks the chunk from the shapes and the card's SM count, and the
  chunks' f32 partials and the merge's tickets live in scratch cached per
  device and stream (``_scratch``), never allocated per call. On an H100
  the tile kernel was at least as fast as ``rpa_kernel`` from 2 rows of
  q_len·groups on, at kv_len 128 and 1024 (``chip_smoke.py`` phase 5,
  ``PERF.md``), so every call with more than one query row takes it.

Both compute the function of the TPU kernels, with one deliberate
difference for non-finite pool contents: rows at or past ``kv_len`` never
reach the output (the TPU kernels zero only V rows past the live pages),
so a NaN in the dead tail of a live page — payload or scale — cannot reach
it. For finite pools the two are the same function. A query row whose mask
is empty (only possible when ``q_len > kv_len``, which no caller produces)
gives zeros.

Quantized pools: each K and V row is dequantized as the JAX package's
gather path and ``_kernel_body_quant`` do it — payload × scale in f32,
rounded to the MODEL dtype (q's), then widened to f32 for the products.
The kernel and the plain version form these values bit for bit alike; from
there the quantized function is K3's over the dequantized rows.

Numerics of the kernels against the plain version (K3 and K4 alike):
the plain version, like the TPU kernel, normalises the softmax in f32
and rounds the probabilities to the dtype of the V rows (the pool dtype
for K3, the model dtype for K4) before the V product; ``rpa_kernel``
keeps an online softmax in f32 and never rounds the probabilities. In
f32 they differ by summation order only. In bf16 (8 significant bits:
rounding moves a value by at most u = 2^-8 of it) each rounded
probability p_j moves by at most u·p_j, which moves output element d by
at most u·M_d, M_d = Σ_j p_j·|v_jd| (the plain version's ``mass``);
then each side rounds its f32 output to bf16, by at most u of it, and
the kernel's f32 output is within u·M_d of the plain one's. In all
|kernel − plain| ≤ u·(1 + u)·M_d + 2u·|out_d|/(1 − u) plus f32 noise
(summation order, ≈ 1e-5 of M_d). ``tolerance`` holds each bf16 element
to ``BF16_UNIT·BF16_MARGIN·(M_d + 2·|out_d|)``, BF16_MARGIN = 1 + 2^-4
covering the u² terms and the f32 noise. At decode, where a row averages
hundreds of keys, M_d ≈ 0.8 of the keys' |V| scale while its largest |V|
is ≈ 4 of it, so this is 5–20× tighter than a bound on the row's
max|V|. f32 elements are held per row to ``F32_TOL`` of the largest |V|
the row attends; every element also gets ``F32_TOL·ROW_FLOOR`` of the
call's largest live |V|, so that values near 0 keep a bound above f32
noise.

The tile path adds one rounding. ``rpa_tile_kernel`` feeds the tensor
cores the unnormalised probabilities p̃_j = 2^(x_j − m), m the running
max when key j's tile is processed, rounded to bf16 as wgmma's A
operand; the rescaling of earlier tiles by 2^(m_old − m_new) and the
division by l = Σ_j p̃_j (f32, never rounded) stay in f32. The rounding
moves each term p̃_j·v_jd by at most u·p̃_j·|v_jd|, so after the
division by l the f32 output moves by at most u·Σ_j p_j·|v_jd| = u·M_d
from the exact one, against the exact one's u·(1 + u)·M_d from the
plain version: |kernel − plain| ≤ u·(2 + u)·M_d + 2u·|out_d|/(1 − u)
plus f32 noise. ``tolerance`` adds that one ``BF16_UNIT·M_d`` term for
the calls ``_tile_path`` sends to the tile kernel, holding their bf16
elements to ``BF16_UNIT·BF16_MARGIN·(2·M_d + 2·|out_d|)``
(u·(2 + u) ≤ 2u·BF16_MARGIN); nothing else changes.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ..models.llama import f32_scale
from ..quant.codec import dequantize_lastdim

__all__ = ["ragged_paged_attention", "ragged_paged_attention_reference",
           "tolerance", "LAUNCHES", "F32_TOL", "BF16_UNIT", "BF16_MARGIN",
           "ROW_FLOOR", "SUPPORTED_HEAD_DIMS", "TILE_HEAD_DIMS"]

# kernel launches by kernel: "ragged_paged_attention" (K3 on rpa_kernel),
# "ragged_paged_attention_tile" (K3 on rpa_tile_kernel), and the same
# with "_quant" for K4; chip_smoke.py zeroes it before the main path and
# reads it after
LAUNCHES: collections.Counter = collections.Counter()

# |kernel − plain| bounds (see the module docstring): f32 differs by
# summation order (inputs of order 1); bf16 by probability and output
# rounding, element by element relative to Σ_j p_j·|v_j| and |out|
# (``tolerance``)
F32_TOL = 1e-4
BF16_UNIT = 2.0 ** -8          # bf16 rounding moves a value by ≤ this of it
BF16_MARGIN = 1.0 + 2.0 ** -4
# share of the call's max|V| that scales every element's floor
# (``tolerance``), so that values near 0 keep a bound above f32 noise
ROW_FLOOR = 2.0 ** -8

SUPPORTED_HEAD_DIMS = (16, 64, 128)
# the tile path (``_tile_path``): bf16 models at these head dims
TILE_HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PAYLOAD_CODE = {torch.int8: 0, torch.float8_e4m3fn: 1}


# rpa_kernel's split of the keys (``_split_plan``): enough blocks for this
# many per SM, chunks of at least this many rows (whole pages), at most
# this many chunks. chip_smoke.py's decode sweep times these against
# other values (PLAN_ALTERNATIVES) on the card; PERF.md has the numbers.
DECODE_WAVES = 4
MIN_CHUNK_ROWS = 128
MAX_SPLITS = 64
# (device, stream) → (f32 workspace, int32 tickets) of rpa_kernel's split
_SCRATCH: dict = {}


def _rows_per_block(span: int, quant: bool) -> int:
    """Query rows (of the q_max·groups axis) one ``rpa_kernel`` block
    holds: 1, 2, 4 or 8, and at most 4 over one-byte pages, where a lane
    holds 16 of a row's elements."""
    if span >= 8:
        return 4 if quant else 8
    return 4 if span > 2 else span


def _split_plan(tiles: int, kv_max: int, page_size: int, n_sm: int):
    """(splits, chunk) of ``rpa_kernel``'s key axis [0, kv_max), kv_max a
    multiple of page_size (the block table's reach): ``splits`` chunks of
    ``chunk`` rows, a whole number of pages, the last one possibly
    shorter, none empty. A pure function of the shapes: 1 chunk when the
    ``tiles`` blocks (slot, kv head, query rows) already number
    DECODE_WAVES per SM; else enough chunks for that many blocks, each of
    at least MIN_CHUNK_ROWS rows (rounded up to pages), at most
    MAX_SPLITS."""
    pages = -(-kv_max // page_size)
    target = DECODE_WAVES * n_sm
    if tiles >= target or pages <= 1:
        return 1, pages * page_size
    min_pages = -(-MIN_CHUNK_ROWS // page_size)
    want = min(-(-target // tiles), max(1, pages // min_pages), MAX_SPLITS)
    chunk_pages = -(-pages // want)
    return -(-pages // chunk_pages), chunk_pages * page_size


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _scratch(device, floats: int, tickets: int):
    """rpa_kernel's split scratch on ``device`` for the current stream: an
    f32 workspace of at least ``floats`` and at least ``tickets`` int32
    tickets, zero between launches (each launch resets those it takes).
    Cached and grown on demand, so a call allocates nothing once the
    largest shape has run; a stream of its own, so that launches on two
    streams never share tickets."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    ws, tk = _SCRATCH.get(key, (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.empty(max(floats, 1), dtype=torch.float32, device=device)
    if tk is None or tk.numel() < tickets:
        tk = torch.zeros(max(tickets, 1), dtype=torch.int32, device=device)
    _SCRATCH[key] = (ws, tk)
    return ws, tk


def _tile_path(q_max: int, hd: int, dtype) -> bool:
    """Whether a call of these shapes runs ``rpa_tile_kernel`` (the tile
    path) rather than ``rpa_kernel``: bf16 models at head dims 64 and 128
    with more than one query row a slot. Decode (q_max = 1), head dim 16
    and f32 models stay on ``rpa_kernel``. The GQA group size does not
    move the line: the measured crossover (module docstring) lies below
    the fewest rows, 2, that a multi-row call has."""
    return dtype == torch.bfloat16 and hd in TILE_HEAD_DIMS and q_max > 1


def _check_tile_page_size(page_size: int) -> None:
    """The tile path gathers 64-row key tiles: a page size must divide 64
    or be a multiple of it."""
    if 64 % page_size and page_size % 64:
        raise ValueError(f"page_size {page_size} neither divides nor is a "
                         "multiple of the tile path's 64-row key tile")


def _check_scales(k_scale, v_scale):
    if (k_scale is None) != (v_scale is None):
        raise ValueError("quantized pools need BOTH k_scale and v_scale "
                         "(got exactly one)")


def _gather(pool, scale, block_table, out_dtype):
    """Every block-table page of ``pool`` as [B, R, KV, hd] rows, R =
    Pmax·page_size; a quantized pool (``scale`` given) comes back
    dequantized to ``out_dtype``."""
    B = block_table.shape[0]
    _, _, KV, hd = pool.shape
    bt = block_table.long()
    rows = pool[bt].reshape(B, -1, KV, hd)
    if scale is not None:
        rows = dequantize_lastdim(rows, scale[bt].reshape(B, -1, KV),
                                  out_dtype)
    return rows


def _masks(q, R, q_lens, kv_lens, groups):
    """(live [B,1,1,R], valid [B,1,S,R]) for the regrouped query rows
    S = Qmax·groups: column j is live when j < kv_len, and valid for row
    s when also j <= kv_len − q_len + s // groups."""
    span = q.shape[1] * groups
    dev = q.device
    cols = torch.arange(R, device=dev)
    qpos = torch.arange(span, device=dev) // groups
    kv_len = kv_lens.to(dev).long()[:, None, None, None]
    q_len = q_lens.to(dev).long()[:, None, None, None]
    live = cols[None, None, None, :] < kv_len
    valid = live & (cols[None, None, None, :]
                    <= kv_len - q_len + qpos[None, None, :, None])
    return live, valid


def _ungroup(x, B, KV, q_max, groups):
    """[B, KV, Qmax·groups, ...] → [B, Qmax, H, ...] (row s = qpos·groups
    + gi of kv head k is query head k·groups + gi)."""
    return x.reshape(B, KV, q_max, groups, *x.shape[3:]) \
        .permute(0, 2, 1, 3, *range(4, x.dim() + 1)) \
        .reshape(B, q_max, KV * groups, *x.shape[3:])


def _plain(q, k_pool, v_pool, block_table, q_lens, kv_lens, page_size,
           k_scale, v_scale, bound_terms=False):
    """The plain version's work: its output [B, Qmax, H, hd] in q.dtype,
    and with ``bound_terms`` also (mass = Σ_j p_j·|v_j| per output
    element, f32, 0 where the output is 0 by rule; the largest |V| among
    the columns each row attends [B, Qmax, H, 1] f32; the call's largest
    live |V|)."""
    _check_scales(k_scale, v_scale)
    B, q_max, H, hd = q.shape
    _, ps, KV, _ = k_pool.shape
    if ps != page_size:
        raise ValueError(f"pool page size {ps} != page_size {page_size}")
    groups = H // KV
    span = q_max * groups
    kc = _gather(k_pool, k_scale, block_table, q.dtype)
    vc = _gather(v_pool, v_scale, block_table, q.dtype)
    qh = q.reshape(B, q_max, KV, groups, hd).permute(0, 2, 1, 3, 4) \
        .reshape(B, KV, span, hd)
    logits = torch.einsum("bksd,brkd->bksr", qh.to(torch.float32),
                          kc.to(torch.float32)) * f32_scale(hd)
    live, valid = _masks(q, kc.shape[1], q_lens, kv_lens, groups)
    logits = logits.masked_fill(~valid, -1e30)
    probs = torch.softmax(logits, dim=-1)
    vz = vc.masked_fill(~live[:, 0, 0, :, None, None], 0).to(torch.float32)
    out = torch.einsum("bksr,brkd->bksd", probs.to(vc.dtype)
                       .to(torch.float32), vz)
    q_len = q_lens.to(q.device).long()[:, None, None, None]
    keep = valid.any(dim=-1, keepdim=True) & (q_len > 0)        # [B,KV,S,1]
    out = out.masked_fill(~keep, 0).to(q.dtype)
    if not bound_terms:
        return _ungroup(out, B, KV, q_max, groups)
    mass = torch.einsum("bksr,brkd->bksd", probs, vz.abs()) \
        .masked_fill(~keep, 0)
    vmax = vz.abs().amax(-1).permute(0, 2, 1)[:, :, None, :]    # [B,KV,1,R]
    row = torch.where(valid, vmax, torch.zeros_like(vmax)).amax(-1)
    return (_ungroup(out, B, KV, q_max, groups),
            _ungroup(mass, B, KV, q_max, groups),
            _ungroup(row, B, KV, q_max, groups)[..., None],
            float(vmax.max()) if vmax.numel() else 0.0)


def ragged_paged_attention_reference(q, k_pool, v_pool, block_table, q_lens,
                                     kv_lens, *, page_size: int,
                                     k_scale=None, v_scale=None):
    """The plain PyTorch version: gather every block-table page (and, for
    quantized pools, its scale page, dequantized to q.dtype), f32 logits
    times 1/sqrt(hd), the mask ``col < kv_len & col <= kv_len − q_len +
    qpos`` filled with -1e30 over the full static width, f32 softmax cast
    to the dtype of the V rows, V rows at or past ``kv_len`` zeroed, f32
    accumulation. Rows are grouped ``qpos*groups + gi`` as in the TPU
    kernel, so a GQA group shares one kv head."""
    return _plain(q, k_pool, v_pool, block_table, q_lens, kv_lens,
                  page_size, k_scale, v_scale)


def tolerance(q, k_pool, v_pool, block_table, q_lens, kv_lens, *,
              page_size: int, k_scale=None, v_scale=None):
    """Bound on |kernel − plain| for each element of the output of the
    same call, [B, Qmax, H, hd] f32. bf16: ``BF16_UNIT·BF16_MARGIN·(M +
    2·|out|)``, M = Σ_j p_j·|v_j| of the element, with a second M for a
    call that ``_tile_path`` sends to the tile kernel; f32: ``F32_TOL``
    times the largest |V| among the columns the element's row attends;
    both plus ``F32_TOL·ROW_FLOOR`` of the call's largest live |V|. V is
    dequantized for a quantized pool. See the module docstring for the
    derivation."""
    out, mass, row, top = _plain(q, k_pool, v_pool, block_table, q_lens,
                                 kv_lens, page_size, k_scale, v_scale,
                                 bound_terms=True)
    floor = F32_TOL * ROW_FLOOR * top
    if q.dtype == torch.float32:
        return (F32_TOL * row + floor).expand(out.shape)
    B, q_max, H, hd = q.shape
    if _tile_path(q_max, hd, q.dtype):
        mass = 2 * mass
    return BF16_UNIT * BF16_MARGIN * (mass + 2 * out.float().abs()) + floor


def ragged_paged_attention(q, k_pool, v_pool, block_table, q_lens, kv_lens,
                           *, page_size: int, k_scale=None, v_scale=None):
    """Ragged paged attention over a shared page pool.

    q           [B, Qmax, H, hd] — slot b's rows [0, q_lens[b]) are queries
                at absolute positions kv_lens[b] − q_lens[b] + r.
    k/v_pool    [num_pages, page_size, KV, hd] — the paged KV pool, in
                q.dtype, or int8 / float8_e4m3fn with the scales below.
    block_table [B, Pmax] int32 — logical → physical page map per slot.
    q_lens      [B] int32 — 0 skips the slot (its output is zeros).
    kv_lens     [B] int32 — live context rows (attend rows < kv_lens[b]).
    k/v_scale   [num_pages, page_size, KV] f32 — the per-(page, row, kv
                head) scales of a quantized pool; both or neither.

    Returns [B, Qmax, H, hd] in q.dtype. CPU tensors run the plain
    version; CUDA tensors run the kernel (K3, or K4 with scales) or
    raise."""
    _check_scales(k_scale, v_scale)
    tensors = [q, k_pool, v_pool, block_table, q_lens, kv_lens]
    if k_scale is not None:
        tensors += [k_scale, v_scale]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"ragged_paged_attention: tensors on several "
                         f"devices {sorted(map(str, devices))}")
    dev = q.device
    if dev.type == "cpu":
        return ragged_paged_attention_reference(
            q, k_pool, v_pool, block_table, q_lens, kv_lens,
            page_size=page_size, k_scale=k_scale, v_scale=v_scale)
    if dev.type != "cuda":
        raise ValueError(f"ragged_paged_attention: unsupported device {dev}")
    return _launch(q, k_pool, v_pool, block_table, q_lens, kv_lens,
                   int(page_size), k_scale, v_scale)


def _launch(q, k_pool, v_pool, block_table, q_lens, kv_lens, page_size,
            k_scale=None, v_scale=None, tile=None):
    """Validate what the kernel takes, allocate the output, launch K3 (or
    K4 when the scales are given) on the current stream and raise on a
    launch error. ``tile`` picks the kernel, ``_tile_path``'s choice when
    None (a caller timing both kernels at one shape passes it)."""
    quant = k_scale is not None
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"ragged_paged_attention: q {tuple(q.shape)}, "
                         f"pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)}")
    B, q_max, H, hd = q.shape
    _, ps, KV, hd_p = k_pool.shape
    if ps != page_size:
        raise ValueError(f"pool page size {ps} != page_size {page_size}")
    if hd_p != hd or hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} (pool {hd_p}) not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if KV < 1 or H % KV:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    if tile is None:
        tile = _tile_path(q_max, hd, q.dtype)
    if tile:
        if q.dtype != torch.bfloat16 or hd not in TILE_HEAD_DIMS:
            raise ValueError(f"the tile path takes bf16 at head dims "
                             f"{TILE_HEAD_DIMS}, not {q.dtype} at {hd}")
        _check_tile_page_size(ps)
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be one of {list(_DTYPE_CODE)}, got "
                        f"{q.dtype}")
    if quant:
        if k_pool.dtype not in _PAYLOAD_CODE or v_pool.dtype != k_pool.dtype:
            raise TypeError(f"quantized pools must share one payload dtype "
                            f"in {list(_PAYLOAD_CODE)}; got {k_pool.dtype}, "
                            f"{v_pool.dtype}")
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.float32:
                raise TypeError(f"{name} must be float32, got {t.dtype}")
            if t.shape != k_pool.shape[:3]:
                raise ValueError(f"{name} shape {tuple(t.shape)} != pool "
                                 f"pages, rows, kv heads "
                                 f"{tuple(k_pool.shape[:3])}")
    elif k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"q/pools must share one dtype in "
                        f"{list(_DTYPE_CODE)}; got {q.dtype}, "
                        f"{k_pool.dtype}, {v_pool.dtype}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or q_lens.shape != (B,) or kv_lens.shape != (B,):
        raise ValueError("block_table must be [B, Pmax], q_lens/kv_lens [B]")
    for name, t in (("block_table", block_table), ("q_lens", q_lens),
                    ("kv_lens", kv_lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    dense = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool)]
    if quant:
        dense += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, t in dense + [("block_table", block_table),
                            ("q_lens", q_lens), ("kv_lens", kv_lens)]:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in dense:
        if t.data_ptr() % 16:       # the kernel's vector loads
            raise ValueError(f"{name} must be 16-byte aligned")
    if B == 0 or q_max == 0:
        return torch.empty_like(q)

    from . import _build
    lib = _build.load("ragged_paged_attention")
    out = torch.empty_like(q)
    max_pages = block_table.shape[1]
    sizes = (B, q_max, H, KV, hd, ps, max_pages)
    strides = (*q.stride()[:3], *k_pool.stride()[:3], *out.stride()[:3])
    scales = (k_scale.data_ptr(), v_scale.data_ptr()) if quant else ()
    codes = (_DTYPE_CODE[q.dtype],) + \
        ((_PAYLOAD_CODE[k_pool.dtype],) if quant else ())
    if tile:
        # the tile path's TMA maps span the pool: its page count
        sizes += () if quant else (k_pool.shape[0],)
        scratch = ()
    else:
        rows = _rows_per_block(q_max * (H // KV), quant)
        tiles = B * KV * -(-q_max * (H // KV) // rows)
        splits, chunk = _split_plan(tiles, max_pages * ps, ps,
                                    _sm_count(q.device.index))
        ws, tk = _scratch(q.device, tiles * splits * rows * (hd + 2), tiles)
        scratch = (ws.data_ptr(), tk.data_ptr())
        sizes += (rows, splits, chunk)
    name = "ragged_paged_attention" + ("_quant" if quant else "") \
        + ("_tile" if tile else "")
    entry = ("rpa_tile" if tile else "rpa") \
        + ("_quant_launch" if quant else "_launch")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, entry)(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *scales,
            block_table.data_ptr(), q_lens.data_ptr(), kv_lens.data_ptr(),
            out.data_ptr(), *scratch, *codes, *sizes, *strides,
            *(k_scale.stride()[:2] if quant else ()), block_table.stride(0),
            ctypes.c_float(f32_scale(hd)), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"cudaError {err} ({_build.error_string(err)})")
    LAUNCHES[name] += 1
    return out
