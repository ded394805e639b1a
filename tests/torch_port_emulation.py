"""numpy (float64) emulations of the algorithms of the port's tile-local CUDA
kernels, for the CPU tests: the kernels themselves only run on the card
(``chip_smoke.py``), so the tests hold these step-for-step copies of their
index arithmetic against the plain PyTorch versions.

- ``dense_block_tile_tc``: ``csrc/rdb_tile.cuh`` (one 8 x 16 tile of a
  dense block on the tensor cores: x staged chunk by chunk with zero outside
  the image, a1..a4 on shrinking windows in swizzled storage, zero outside
  the image, M padded to 64-row blocks, A gathered in the permuted k order
  and split into TF32 hi/lo, B read through ``pack_rdb_weights_tc``'s
  core-matrix layout, a partial sum per chunk and kernel row);
- ``emulate_k6``: ``csrc/rdb_banded.cu`` (one tile per block);
- ``emulate_k5``: ``csrc/rrdb_sweep.cu`` (the wavefront sweep with its two
  4-slot band rings, two bands of lag between dense blocks);
- ``emulate_tc_stage``, ``emulate_k1_tc``, ``emulate_k4_tc``:
  ``csrc/conv3x3_tc.cuh`` and the stage sequence of ``csrc/rdb.cu`` (the
  3xTF32 implicit-GEMM conv: halo and weight staging with zero fill and the
  workspace's channel pitch, the hi/lo splits into the kernel's shared-memory
  layouts, the wgmma fragments read back from them, the partial sum per
  kernel row). Products are exact and sums float64, so these show the
  split's precision, not the tensor cores' own rounding;
- ``dense_block_tile_bf16`` and ``bf16=True`` on ``emulate_k6`` /
  ``emulate_k5``: ``rdb_tile.cuh``'s bf16 route (one flat shared memory of
  bf16 words poisoned with NaN, stepped unit by unit as the kernel steps it:
  the weight ring, x's fp32 landing slots aliasing the a-region, x rounded
  once by ``bf16_rn`` into its resident planes, a1..a4 stored in bf16 by the
  epilogues with zero outside the image, the k16 A fragments read lane by
  lane, ``pack_rdb_weights_tc(mxu_bf16=True)``'s bf16 core matrices read as
  the B descriptor reads them for both N halves of stage 5, one float64
  chain per stage);
- ``emulate_tc_stage_bf16`` and ``bf16=True`` on ``emulate_k1_tc`` /
  ``emulate_k4_tc``: ``conv3x3_tc.cuh``'s bf16 route,
  ``conv3x3_tc_stage_bf16`` (persistent blocks walking the tiles, the
  2-slot rings of weights, rounded halo and fp32 landing area stepped as
  the kernel steps them and poisoned with NaN before first use, each
  thread's own landing pieces, the halo rounded by ``bf16_rn`` into
  [k16 step][pixel][16], the k16 A fragments read back lane by lane,
  ``pack_conv_weight(mxu_bf16=True)``'s bf16 core matrices read as the B
  descriptor reads them, every product of a stage on one accumulator);
- ``emulate_k2_tc``: K2 / K7 in ``csrc/deform_tail.cu`` (the 64 -> 64
  deformable conv as a 3xTF32 implicit GEMM: the 16 x 16 tile's window with
  zero fill in 16-channel blocks, each lane's blended corners split into
  TF32 hi/lo, B read through ``pack_deform64_weight_tc``'s core-matrix
  layout, a partial sum per wgmma group);
- ``emulate_k3_window``: K3 in ``csrc/deform_tail.cu`` (the 8 x 32 tile's
  z window with zero fill, four corners per tap read from it);
- ``emulate_k9``: ``csrc/deform_zform.cu`` (C_out 64 and 16: a 7 x 16
  tile's window in 16-channel blocks with C_in zero-padded, per tap the
  3xTF32 projection of the 252 reachable positions padded to 256 M rows,
  A split from the raw window, B read through ``pack_deform64_weight_tc``'s
  layout, a partial sum per window block, z_t stored in float32, then four
  corners per pixel; C_out 1: a 32 x 32 tile's window projected onto the
  nine tap fields 8 channels at a time, then K3's sampling).
"""

import functools

import numpy as np

F, G = 64, 32
TH, TW, MARGIN = 8, 16, 5  # K5/K6 tile rows (K5's band) and columns, input halo
SLOTS, LAG = 4, 2
CK = 8  # channels per chunk: one k8 step
SLOT_CHANNELS = np.array([2 * (k % 4) + k // 4 for k in range(8)])  # k slot -> channel


def _stage_cin(j):
    return F + G * (j - 1)


def _stage_cout(j):
    return G if j < 5 else F


def _win(k):
    """Rows and columns of source k's window (0 = x, 1..4 = a_k, 5 = tile)."""
    return TH + 2 * (MARGIN - k), TW + 2 * (MARGIN - k)


def _stage_b_tc(w_packed):
    """The five stages' B operands from ``pack_rdb_weights_tc``'s layout, as
    the wgmma descriptors read them: [chunk][ky][kx][hi|lo] (8 slots, C_out)
    float64 matrices, slot k of chunk c being channel 8 c + SLOT_CHANNELS[k]."""
    out, off = [], 0
    for j in range(1, 6):
        cin, cout = _stage_cin(j), _stage_cout(j)
        size = 2 * 9 * cin * cout
        core = np.asarray(w_packed[off:off + size], np.float32).reshape(
            cin // CK, 3, 3, 2, cout // 8, 2, 8, 4)  # [n/8][k/4][n%8][k%4]
        out.append(core.transpose(0, 1, 2, 3, 5, 7, 4, 6)
                   .reshape(cin // CK, 3, 3, 2, CK, cout).astype(np.float64))
        off += size
    return out


def _inside(lo, n, limit):
    idx = lo + np.arange(n)
    return idx, (idx >= 0) & (idx < limit)


def _swizzled(q, chunk):
    """Float offset of chunk ``chunk`` of a1..a4's pixel q: [pixel][chunk ^
    (pixel & 3)][8] at a 32-float pixel pitch."""
    return q * G + ((chunk ^ (q & 3)) << 3)


def dense_block_tile_tc(load, b_tc, biases, ty0, tx0, h, w, passes=3):
    """One 8 x 16 tile of ``csrc/rdb_tile.cuh``: ``load(gy, gx)`` gives the
    block input at in-image pixels (index arrays). x is staged chunk by chunk
    as the kernel's [pixel][8] slot with zero outside the image; a1..a4 live in
    flat swizzled storage, written and read with the kernel's offsets. Per
    stage: M = the window's pixels padded to 64-row blocks (rows past the
    window read its last pixel), A gathered per tap in the permuted k order
    and split into TF32 hi/lo, B from ``_stage_b_tc``, a partial sum per
    (chunk, kernel row) added to the running sum; products exact, sums
    float64. ``passes`` 1 keeps hi.hi only. Returns (conv5 + b5 in float32,
    in-image mask) over the whole tile."""
    xr, xc = _win(0)
    gy, iny = _inside(ty0 - MARGIN, xr, h)
    gx, inx = _inside(tx0 - MARGIN, xc, w)
    x_win = np.zeros((xr, xc, F), np.float32)
    yy, xx = np.meshgrid(gy, gx, indexing="ij")
    m = iny[:, None] & inx[None, :]
    x_win[m] = load(yy[m], xx[m])
    x_win = x_win.reshape(-1, F)
    acts = {}  # k -> flat swizzled a_k
    b_off = 0
    for j in range(1, 6):
        rows, cols = _win(j)
        npix = rows * cols
        r = np.arange(-(-npix // 64) * 64)
        p = np.minimum(r, npix - 1)
        oy, ox = p // cols, p % cols
        cout = _stage_cout(j)
        acc = np.zeros((len(r), cout))
        for c in range(_stage_cin(j) // CK):
            if c < F // CK:  # the staged x chunk, [pixel][8], no swizzle
                k, store = 0, x_win[:, CK * c:CK * (c + 1)].reshape(-1)
                offset = lambda q: q * CK  # noqa: E731
            else:
                k = 1 + (c - F // CK) // (G // CK)
                cl = (c - F // CK) % (G // CK)
                store = acts[k]
                offset = lambda q, cl=cl: _swizzled(q, cl)  # noqa: E731
            kcols, d = _win(k)[1], j - 1 - k
            for ky in range(3):
                part = np.zeros_like(acc)
                for kx in range(3):
                    q = (oy + ky + d) * kcols + ox + kx + d
                    a = store[offset(q)[:, None] + SLOT_CHANNELS[None, :]]
                    bh, bl = b_tc[j - 1][c, ky, kx]
                    ah, al = (v.astype(np.float64) for v in split_tf32(a))
                    part += ah @ bh
                    if passes == 3:
                        part += al @ bh + ah @ bl
                acc += part
        # epilogue, in float32
        v = acc[:npix].astype(np.float32) + np.asarray(biases[b_off:b_off + cout], np.float32)
        b_off += cout
        ogy = ty0 - (MARGIN - j) + oy[:npix]
        ogx = tx0 - (MARGIN - j) + ox[:npix]
        inside = (ogy >= 0) & (ogy < h) & (ogx >= 0) & (ogx < w)
        if j == 5:
            return v.reshape(TH, TW, F), inside.reshape(TH, TW)
        flat = np.full(npix * G, np.nan, np.float32)
        val = np.where(inside[:, None], np.where(v >= 0, v, np.float32(0.2) * v), 0)
        for chunk in range(G // CK):
            dst = _swizzled(np.arange(npix), chunk)[:, None] + np.arange(CK)[None, :]
            flat[dst] = val[:, CK * chunk:CK * (chunk + 1)]
        assert not np.isnan(flat).any(), "a_j storage not fully written"
        acts[j] = flat
    raise AssertionError("unreachable")


def _tile_span(t0, limit, size):
    return slice(t0, min(t0 + size, limit)), min(t0 + size, limit) - t0


def _tile_fn(w_packed, b_packed, passes, bf16, unit_steps):
    """One dense block's tile body: ``tile(load, ty0, tx0, h, w)``, the 3xTF32
    route (``passes``) or the bf16 route (``unit_steps``)."""
    if bf16:
        bits = _weights(w_packed, True)
        return lambda load, ty0, tx0, h, w: dense_block_tile_bf16(
            load, bits, b_packed, ty0, tx0, h, w, unit_steps)
    b_tc = _stage_b_tc(w_packed)
    return lambda load, ty0, tx0, h, w: dense_block_tile_tc(
        load, b_tc, b_packed, ty0, tx0, h, w, passes)


def emulate_k6(x, w_packed, b_packed, scaling, passes=3, bf16=False, unit_steps=2):
    """csrc/rdb_banded.cu: every 8 x 16 tile from its own input window, out =
    x + s * v in float32. ``bf16``: the bf16 route, ``w_packed`` being
    ``pack_rdb_weights_tc(mxu_bf16=True)``'s bf16 tensor."""
    n, h, w, _ = x.shape
    x = np.asarray(x, np.float32)
    tile = _tile_fn(w_packed, b_packed, passes, bf16, unit_steps)
    out = np.full(x.shape, np.nan, np.float32)
    for i in range(n):
        for ty0 in range(0, h, TH):
            for tx0 in range(0, w, TW):
                v, _ = tile(lambda gy, gx: x[i, gy, gx], ty0, tx0, h, w)
                (ys, ny), (xs, nx) = _tile_span(ty0, h, TH), _tile_span(tx0, w, TW)
                out[i, ys, xs] = x[i, ys, xs] + np.float32(scaling) * v[:ny, :nx]
    return out


def emulate_k5(x, w_packed, b_packed, scaling, bf16=False, unit_steps=2):
    """csrc/rrdb_sweep.cu: step s runs RDB1 band s, RDB2 band s-2 and RDB3
    band s-4 (bands of the tile's 8 rows, 8 x 16 tiles), every tile of a step
    reading the state before the step; the block outputs live in 4-slot rings
    that start as NaN, so a read of a slot that holds no band yet poisons the
    result. Asserts that no step writes a ring slot it also reads. ``bf16``:
    the bf16 route, ``w_packed`` being ``pack_rrdb_weights_tc(mxu_bf16=True)``'s
    bf16 tensor."""
    n, h, w, _ = x.shape
    x = np.asarray(x, np.float32)
    bands = -(-h // TH)
    weights = _weights(w_packed, bf16)
    block = (1 if bf16 else 2) * sum(9 * _stage_cin(j) * _stage_cout(j) for j in range(1, 6))
    nb = F + 4 * G
    tiles = [_tile_fn(weights[p * block:(p + 1) * block], b_packed[p * nb:(p + 1) * nb], 3,
                      bf16, unit_steps) for p in range(3)]
    rings = [np.full((SLOTS, n, TH, w, F), np.nan, np.float32) for _ in range(2)]
    out = np.full(x.shape, np.nan, np.float32)
    s = np.float32(scaling)
    for step in range(bands + 2 * LAG):
        before = [r.copy() for r in rings]
        reads, writes = set(), set()
        for p in range(3):
            band = step - LAG * p
            if not 0 <= band < bands:
                continue
            for i in range(n):
                def load(gy, gx, p=p, i=i):
                    if p == 0:
                        return x[i, gy, gx]
                    reads.update((p - 1, int(sl)) for sl in np.unique(gy // TH % SLOTS))
                    return before[p - 1][gy // TH % SLOTS, i, gy % TH, gx]

                for tx0 in range(0, w, TW):
                    v, _ = tiles[p](load, band * TH, tx0, h, w)
                    (ys, ny), (xs, nx) = _tile_span(band * TH, h, TH), _tile_span(tx0, w, TW)
                    a = (x[i, ys, xs] if p == 0
                         else before[p - 1][band % SLOTS, i, :ny, xs])
                    t = a + s * v[:ny, :nx]
                    if p < 2:
                        writes.add((p, band % SLOTS))
                        rings[p][band % SLOTS, i, :ny, xs] = t
                    else:
                        out[i, ys, xs] = x[i, ys, xs] + s * t
        assert not reads & writes, f"step {step} reads and writes ring slots {reads & writes}"
    return out


# --- csrc/conv3x3_tc.cuh ----------------------------------------------------

TC_TILE_W, TC_TILE_ROWS, TC_CK = 16, 16, 8
TC_HALO_W, TC_HALO_H = TC_TILE_W + 2, TC_TILE_ROWS + 2
WS = F + 4 * G  # the dense workspace's channel pitch
# conv3x3_tc.cuh's EpilogueMode, in its order
LRELU, SCALED_SKIP, DOUBLE_SKIP, LINEAR, ADD, ADD_LRELU = range(6)


def tf32_rna(a):
    """``cvt.rna.tf32.f32``: float32 -> float32 with 10 mantissa bits, rounded
    to nearest, ties away from zero (adding half an ulp to the magnitude bits
    carries into the exponent where it must)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def bf16_rn(a):
    """``cvt.rn.bf16x2.f32`` on finite values: float32 -> float32 with 7
    mantissa bits, rounded to nearest, ties to even."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    bits = bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1))
    return (bits & np.uint32(0xFFFF0000)).view(np.float32)


def split_tf32(a):
    """x = hi + lo, both TF32; the kernel's ``split_pair``."""
    a = np.asarray(a, np.float32)
    hi = tf32_rna(a)
    return hi, tf32_rna(a - hi)


def _split4(a, b):
    """``split_pair``: {hi(a), hi(b), lo(a), lo(b)} along the last axis."""
    (ha, la), (hb, lb) = split_tf32(a), split_tf32(b)
    return np.stack([ha, hb, la, lb], -1)


_G, _T = np.arange(32) >> 2, np.arange(32) & 3  # lane -> (group, thread in group)


def emulate_tc_stage(ws_in, in_pitch, cin, w, bias, n, h, wd, cout, mode, out, out_pitch,
                     res=None, res_pitch=0, skip=None, scaling=0.0, passes=3):
    """One launch of ``conv3x3_tc_stage``: flat float32 arrays with the
    kernel's pitches (``ws_in``: pixel p channel c at ``p * in_pitch + c``);
    ``w``, ``bias``: the stage's packed weights [C_out/32][C_in][9][32] and
    biases. Writes ``out`` in place. ``passes`` 3 is the kernel (lo.hi, hi.lo,
    hi.hi); 1 keeps hi.hi only, a single TF32 pass."""
    slice_ = TC_CK * 9 * 32
    hpix = TC_HALO_W * TC_HALO_H
    p = np.arange(hpix)
    for img in range(n):
        for y0 in range(0, h, TC_TILE_ROWS):
            for x0 in range(0, wd, TC_TILE_W):
                gy, gx = y0 + p // TC_HALO_W - 1, x0 + p % TC_HALO_W - 1
                inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < wd)
                src = ((img * h + np.where(inside, gy, 0)) * wd + np.where(inside, gx, 0))
                acc = np.zeros((TC_TILE_ROWS, 16, cout))
                for c0 in range(0, cin, TC_CK):
                    # cp.async: zero fill outside the image, the workspace's pitch
                    cols = src[:, None] * in_pitch + c0 + np.arange(TC_CK)
                    raw_halo = np.where(inside[:, None], ws_in[cols], 0).astype(np.float32)
                    i = np.arange((cout // 32) * slice_ // 4)
                    ct, r = i // (slice_ // 4), i % (slice_ // 4)
                    raw_w = np.empty((cout // 32) * slice_, np.float32)
                    for k in range(4):
                        raw_w[ct * slice_ + 4 * r + k] = w[(ct * cin + c0) * 288 + 4 * r + k]
                    # the splits, in the kernel's shared-memory layouts
                    pairs = raw_halo.reshape(-1, 2)
                    s_halo = _split4(pairs[:, 0], pairs[:, 1])  # [pixel * 4 + t][4]
                    i = np.arange(9 * cout * 2)
                    tap, co, kc = i // (2 * cout), (i >> 1) % cout, i & 1
                    rw = (co >> 5) * slice_ + kc * 9 * 32 + tap * 32 + (co & 31)
                    a4 = _split4(raw_w[rw], raw_w[rw + 2 * 288])
                    b4 = _split4(raw_w[rw + 4 * 288], raw_w[rw + 6 * 288])
                    s_w = np.empty(9 * 2 * cout * TC_CK, np.float32)
                    d = tap * 2 * cout * TC_CK + (co >> 3) * 64 + kc * 32 + (co & 7) * 4
                    for k, (src4, comp) in enumerate([(a4, 0), (a4, 1), (b4, 0), (b4, 1)]):
                        s_w[d + k] = src4[:, comp]
                        s_w[d + cout * TC_CK + k] = src4[:, 2 + comp]
                    for ky in range(3):
                        part = np.zeros_like(acc)
                        for kx in range(3):
                            # B per the descriptor: core matrices [n/8][k/4][n%8][k%4]
                            blk = s_w[(3 * ky + kx) * 2 * cout * TC_CK:][:2 * cout * TC_CK]
                            bh, bl = (blk[o:o + cout * TC_CK].reshape(cout // 8, 2, 8, 4)
                                      .transpose(1, 3, 0, 2).reshape(8, cout)
                                      for o in (0, cout * TC_CK))
                            # A fragments: warp = tile row, lane (g, t); slot t is
                            # channel 2t, slot t + 4 channel 2t + 1
                            row = np.arange(TC_TILE_ROWS)[:, None]
                            base = ((row + ky) * TC_HALO_W + _G + kx) * 4 + _T
                            v0, v8 = s_halo[base], s_halo[base + 8 * 4]
                            ah = np.empty((TC_TILE_ROWS, 16, 8))
                            al = np.empty_like(ah)
                            for a, (x, y) in ((ah, (0, 1)), (al, (2, 3))):
                                a[:, _G, _T], a[:, _G + 8, _T] = v0[..., x], v8[..., x]
                                a[:, _G, _T + 4] = v0[..., y]
                                a[:, _G + 8, _T + 4] = v8[..., y]
                            bh64, bl64 = bh.astype(np.float64), bl.astype(np.float64)
                            part += ah @ bh64
                            if passes == 3:
                                part += al @ bh64 + ah @ bl64
                        acc += part
                _store_tile(acc, img, y0, x0, h, wd, cout, bias, mode, out, out_pitch, res,
                            res_pitch, skip, scaling)


def _store_tile(acc, img, y0, x0, h, wd, cout, bias, mode, out, out_pitch, res, res_pitch,
                skip, scaling):
    """``store_row`` for a whole 16 x 16 tile: v = acc + bias through the
    epilogue mode, in float32, in the plain composition's order."""
    rows = y0 + np.arange(TC_TILE_ROWS)[:, None]
    cols = x0 + np.arange(16)[None, :]
    keep = (rows < h) & (cols < wd)
    pix = ((img * h + rows) * wd + cols)[keep]
    v = acc[keep].astype(np.float32) + bias[:cout].astype(np.float32)
    ch = np.arange(cout)
    if mode == LRELU:
        o = np.where(v >= 0, v, np.float32(0.2) * v)
    elif mode == LINEAR:
        o = v
    elif mode in (ADD, ADD_LRELU):
        o = v + res[pix[:, None] * res_pitch + ch]
        if mode == ADD_LRELU:
            o = np.where(o >= 0, o, np.float32(0.2) * o)
    else:
        rv = res[pix[:, None] * res_pitch + ch]
        o = rv + np.float32(scaling) * v
        if mode == DOUBLE_SKIP:
            o = skip[pix[:, None] * F + ch] + np.float32(scaling) * o
    out[pix[:, None] * out_pitch + ch] = o


# conv3x3_tc.cuh's bf16 route
BF_CHUNK = 32  # kBfChunk: input channels per chunk
BF_POISON = np.uint16(0x7FC0)  # a bf16 NaN: what an unwritten ring slot holds here


def bf16_bits(t):
    """A ``torch.bfloat16`` tensor's raw bits as a flat numpy uint16 array."""
    import torch

    return t.contiguous().view(torch.int16).numpy().view(np.uint16).reshape(-1)


def _bf16_value(bits):
    """bf16 bits -> their exact value, float64."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(np.float32).astype(
        np.float64)


def _bf16_of(values):
    """float32 values -> the bits of ``bf16_rn`` (round to nearest even)."""
    return (bf16_rn(values).view(np.uint32) >> 16).astype(np.uint16)


def k16_a_fragments(mem, base, q):
    """The A operands of wgmma.m64nNk16 for M rows whose pixels are ``q``
    (one per row, 16 rows a warp), read lane by lane from the bf16 plane at
    ``mem[base:]`` ([pixel][16] bf16 bits) as the kernels read them: lane
    (g, t) of a warp loads 8 bytes at the pixel of its row g (v0) and 8 at
    that of row g + 8 (v8), channels 4t..4t + 3 of the plane, into registers
    {v0.x, v8.x, v0.y, v8.y}; register r, low half first, holds row
    g + 8 (r % 2) at k slots 2t + 8 (r // 2) and the next (the wgmma A
    fragment layout). Returns (rows, 16 slots) float64."""
    row, lane_off, slot = _k16_lanes(len(q))
    a = np.full((len(q), 16), np.nan)
    a[row, slot] = _bf16_value(mem[base + q[row] * 16 + lane_off])
    return a


@functools.lru_cache(maxsize=None)
def _k16_lanes(rows):
    """``k16_a_fragments``' lanes for ``rows`` M rows: each register half's
    row, its offset in the lane's 8-byte loads, and its k slot."""
    warp, g, t, r, half = np.meshgrid(np.arange(rows // 16), np.arange(8), np.arange(4),
                                      np.arange(4), np.arange(2), indexing="ij")
    row = 16 * warp + g + 8 * (r % 2)  # v8 for odd r
    return row, 4 * t + 2 * (r // 2) + half, 2 * t + 8 * (r // 2) + half  # .y for r >= 2


def bf16_a_fragments(halo, k, tap):
    """``k16_a_fragments`` for ``conv3x3_tc_stage_bf16``'s tile at k16 step
    ``k`` and ``tap``: the 16 warps are the tile rows, a warp's rows its 16
    pixels shifted by the tap in the rounded halo slot ``halo`` ([k16
    step][pixel][16] bf16 bits). Returns (16 rows, 16 pixels, 16 slots)."""
    hpix = TC_HALO_W * TC_HALO_H
    row, pix = np.meshgrid(np.arange(TC_TILE_ROWS), np.arange(16), indexing="ij")
    q = (row + tap // 3) * TC_HALO_W + pix + tap % 3
    return k16_a_fragments(halo, k * hpix * 16, q.reshape(-1)).reshape(TC_TILE_ROWS, 16, 16)


def bf16_b_operand(slot_w, k, tap, cout, n=None, start=0):
    """The B operand (16 k slots, ``n`` columns, default C_out) of k16 step
    ``k`` and ``tap`` from a weight slot (bf16 bits) packed at C_out, read
    through the descriptor from ``start`` values further on: core matrices
    of 8 rows x 16 bytes, 128 B apart along K (leading byte offset), 256 B
    apart along N (stride byte offset)."""
    base = (k * 9 + tap) * 16 * cout + start
    kk, nn = np.meshgrid(np.arange(16), np.arange(n or cout), indexing="ij")
    idx = base + (nn // 8) * 128 + (kk // 8) * 64 + (nn % 8) * 8 + kk % 8
    return _bf16_value(slot_w[idx])


def emulate_tc_stage_bf16(ws_in, in_pitch, cin, w_bits, bias, n, h, wd, cout, mode, out,
                          out_pitch, res=None, res_pitch=0, skip=None, scaling=0.0, grid=3):
    """One launch of ``conv3x3_tc_stage_bf16`` on ``grid`` persistent blocks:
    as ``emulate_tc_stage``, with ``w_bits`` the stage's bf16 weights as
    ``pack_conv_weight(mxu_bf16=True)`` packs them (raw bits). Each block
    steps through (tile, chunk) as the kernel does, with its own rings
    poisoned with NaN; a read of a slot before its copy lands makes the
    output NaN."""
    hpix = TC_HALO_W * TC_HALO_H
    steps_k = BF_CHUNK // 16
    w_elems, halo_elems = BF_CHUNK * 9 * cout, hpix * BF_CHUNK
    pieces = halo_elems // 4
    tiles_x, tiles_y = -(-wd // TC_TILE_W), -(-h // TC_TILE_ROWS)
    tiles, chunks = tiles_x * tiles_y * n, cin // BF_CHUNK
    assert cin % BF_CHUNK == 0
    i = np.arange(pieces)
    pp, c4 = i // (BF_CHUNK // 4), i % (BF_CHUNK // 4)
    # each piece's place in the rounded halo: [k16 step][pixel][16]
    halo_at = ((c4 >> 2) * hpix + pp) * 16 + 4 * (c4 & 3)
    for block in range(min(tiles, grid)):
        s_w = np.full((2, w_elems), BF_POISON)
        s_halo = np.full((2, halo_elems), BF_POISON)
        s_land = np.full((2, halo_elems), np.nan, np.float32)
        steps = ((tiles - 1 - block) // grid + 1) * chunks

        def tile_of(s):
            tile = block + (s // chunks) * grid
            return tile // (tiles_x * tiles_y), tile // tiles_x % tiles_y * TC_TILE_ROWS, \
                tile % tiles_x * TC_TILE_W

        def land(s):
            img, y0, x0 = tile_of(s)
            gy, gx = y0 + pp // TC_HALO_W - 1, x0 + pp % TC_HALO_W - 1
            inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < wd)
            src = (img * h + np.where(inside, gy, 0)) * wd + np.where(inside, gx, 0)
            cols = src[:, None] * in_pitch + s % chunks * BF_CHUNK + 4 * c4[:, None] \
                + np.arange(4)
            s_land[s & 1] = np.where(inside[:, None], ws_in[cols], 0).reshape(-1)

        def stage_w(s):
            s_w[s & 1] = w_bits[s % chunks * w_elems:(s % chunks + 1) * w_elems]

        def round_halo(s):
            dst = s_halo[s & 1]
            for e in range(4):
                dst[halo_at + e] = _bf16_of(s_land[s & 1][4 * i + e])

        stage_w(0)
        land(0)
        if steps > 1:
            land(1)
        round_halo(0)
        acc = None
        for s in range(steps):
            q = s % chunks
            if s + 1 < steps:
                stage_w(s + 1)
            if s + 2 < steps:
                land(s + 2)
            if q == 0:
                acc = np.zeros((TC_TILE_ROWS, 16, cout))
            halo, ws = s_halo[s & 1], s_w[s & 1]
            for k in range(steps_k):  # nine products a k16 step, all on acc
                for tap in range(9):
                    acc += bf16_a_fragments(halo, k, tap) @ bf16_b_operand(ws, k, tap, cout)
                if k == 0 and s + 1 < steps:
                    round_halo(s + 1)
            if q == chunks - 1:
                img, y0, x0 = tile_of(s)
                _store_tile(acc, img, y0, x0, h, wd, cout, bias, mode, out, out_pitch, res,
                            res_pitch, skip, scaling)


def _stage_fn(passes, bf16):
    """One stage launch: ``emulate_tc_stage`` at ``passes``, or the bf16
    route's ``emulate_tc_stage_bf16``."""
    if bf16:
        return emulate_tc_stage_bf16
    return lambda *a, **kw: emulate_tc_stage(*a, **kw, passes=passes)


def _weights(w_packed, bf16):
    """The packed weights as the kernel reads them: float32, or bf16 bits
    (of a ``torch.bfloat16`` tensor, or already bits)."""
    if not bf16:
        return np.asarray(w_packed, np.float32)
    return w_packed if isinstance(w_packed, np.ndarray) else bf16_bits(w_packed)


def _dense_stages(ws, w, b, n, h, wd, passes, bf16=False):
    """rdb.cu ``dense_stages``: stages 1-4 on the flat workspace; returns the
    offsets of stage 5's weights and biases."""
    stage, off = _stage_fn(passes, bf16), 0
    for j in range(4):
        cin = F + G * j
        view = ws[cin:]  # out = ws + cin, pitch 192
        stage(ws, WS, cin, w[off:], b[G * j:], n, h, wd, G, LRELU, view, WS)
        off += cin * 9 * G
    return off, 4 * G


def emulate_k1_tc(x, w_packed, b_packed, scaling, passes=3, bf16=False):
    """csrc/rdb.cu ``rdb_forward``: x into the workspace, four stages, stage 5
    with out = x + s * (conv + b). ``bf16``: the bf16 route, ``w_packed``
    being ``pack_rdb_weights(mxu_bf16=True)``'s bf16 tensor."""
    n, h, wd, _ = x.shape
    x = np.ascontiguousarray(x, np.float32)
    ws = np.zeros(n * h * wd * WS, np.float32)
    ws.reshape(-1, WS)[:, :F] = x.reshape(-1, F)
    w, b = _weights(w_packed, bf16), np.asarray(b_packed, np.float32)
    wo, bo = _dense_stages(ws, w, b, n, h, wd, passes, bf16)
    out = np.empty(x.size, np.float32)
    _stage_fn(passes, bf16)(ws, WS, WS, w[wo:], b[bo:], n, h, wd, F, SCALED_SKIP, out, F,
                            res=x.reshape(-1), res_pitch=F, scaling=scaling)
    return out.reshape(x.shape)


def emulate_k4_tc(x, w_packed, b_packed, scaling, passes=3, bf16=False):
    """csrc/rdb.cu ``rrdb_forward``: two workspaces in ping-pong, stage 5 of
    blocks 1 and 2 writing the next block's input into the other workspace,
    the outer skip folded into block 3's last epilogue. ``bf16`` as
    ``emulate_k1_tc``'s."""
    n, h, wd, _ = x.shape
    x = np.ascontiguousarray(x, np.float32)
    cur, nxt = (np.zeros(n * h * wd * WS, np.float32) for _ in range(2))
    cur.reshape(-1, WS)[:, :F] = x.reshape(-1, F)
    block = sum(9 * (F + G * j) * (G if j < 4 else F) for j in range(5))
    out = np.empty(x.size, np.float32)
    stage, weights = _stage_fn(passes, bf16), _weights(w_packed, bf16)
    for p in range(3):
        w = weights[p * block:(p + 1) * block]
        b = np.asarray(b_packed[p * WS:(p + 1) * WS], np.float32)
        wo, bo = _dense_stages(cur, w, b, n, h, wd, passes, bf16)
        if p < 2:
            stage(cur, WS, WS, w[wo:], b[bo:], n, h, wd, F, SCALED_SKIP, nxt, WS,
                  res=cur, res_pitch=WS, scaling=scaling)
            cur, nxt = nxt, cur
        else:
            stage(cur, WS, WS, w[wo:], b[bo:], n, h, wd, F, DOUBLE_SKIP, out, F,
                  res=cur, res_pitch=WS, skip=x.reshape(-1), scaling=scaling)
    return out.reshape(x.shape)


# --- csrc/rdb_tile.cuh's bf16 route ------------------------------------------


def _pix(k):
    rows, cols = _win(k)
    return rows * cols


def dense_block_tile_bf16(load, w_bits, biases, ty0, tx0, h, w, unit_steps=2):
    """One 8 x 16 tile of ``rdb_tile.cuh``'s bf16 route (``stage_bf16``):
    ``load(gy, gx)`` gives the block input at in-image pixels, ``w_bits``
    the block's ``pack_rdb_weights_tc(mxu_bf16=True)`` bits. Shared memory is
    one flat array of bf16 words laid out as the kernel's, poisoned with NaN:
    a1..a4 ([plane][pixel][16] each), the resident x ([plane][pixel][16]),
    the weight ring (2 slots of two k16 steps, ``kBfSteps``, or 3 of one
    with ``unit_steps`` 1); x's two fp32 landing slots alias the a-region.
    Unit u
    (stage, k16 steps) is issued ``ahead`` units before it runs: its weights
    into slot u % ring and, for stage 1's units, their x planes into landing
    slot plane % 2, zero outside the image; at unit u's barrier its planes
    are rounded by ``bf16_rn`` into the resident x. Per stage: M = the
    window's pixels padded to 64-row blocks (rows past the window read its
    last pixel), A from ``k16_a_fragments``, B through the descriptor
    (``bf16_b_operand``, stage 5's second N half 512 values further on), one
    float64 sum per stage; stages 1-4 store bf16(lrelu(v)), zero outside the
    image. Returns (conv5 + b5 in float32, in-image mask) over the tile."""
    ring = 3 if unit_steps == 1 else 2
    ahead = ring - 1
    act_off = [int(sum(_pix(m) * G for m in range(1, k))) for k in range(1, 6)]
    x_off, plane = act_off[4], _pix(0) * 16
    slot_elems = unit_steps * 16 * 9 * F
    ring_off = x_off + 4 * plane
    smem = np.full(ring_off + ring * slot_elems, BF_POISON, np.uint16)
    land = smem[:4 * plane].view(np.float32).reshape(2, plane)  # aliases a1, a2
    units, woff, off = [], {}, 0
    for j in range(1, 6):
        woff[j] = off
        units += [(j, uu) for uu in range(_stage_cin(j) // 16 // unit_steps)]
        off += 9 * _stage_cin(j) * _stage_cout(j)
    x_units = 4 // unit_steps
    piece = np.arange(plane // 4)
    pp, c4 = piece >> 2, piece & 3
    xc = _win(0)[1]
    gy, gx = ty0 - MARGIN + pp // xc, tx0 - MARGIN + pp % xc
    inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)

    def issue(u):
        if u >= len(units):
            return
        j, uu = units[u]
        n = unit_steps * 16 * 9 * _stage_cout(j)
        dst = ring_off + (u % ring) * slot_elems
        smem[dst:dst + n] = w_bits[woff[j] + uu * n:][:n]
        for e in range(unit_steps if u < x_units else 0):
            pl = u * unit_steps + e
            vals = np.zeros((len(piece), 4), np.float32)
            ch = 16 * pl + 4 * c4[inside][:, None] + np.arange(4)
            vals[inside] = np.asarray(load(gy[inside], gx[inside]), np.float32)[
                np.arange(int(inside.sum()))[:, None], ch]
            land[pl % 2] = vals.reshape(-1)

    def advance(u):
        for e in range(unit_steps if u < x_units else 0):
            pl = u * unit_steps + e
            smem[x_off + pl * plane:x_off + (pl + 1) * plane] = _bf16_of(land[pl % 2])
        issue(u + ahead)

    for u in range(ahead):
        issue(u)
    u, b_off = 0, 0
    for j in range(1, 6):
        rows, cols = _win(j)
        npix = rows * cols
        r = np.arange(-(-npix // 64) * 64)
        p = np.minimum(r, npix - 1)
        oy, ox = p // cols, p % cols
        cout = _stage_cout(j)
        acc = np.zeros((len(r), cout))
        for uu in range(_stage_cin(j) // 16 // unit_steps):
            advance(u)
            slot = smem[ring_off + (u % ring) * slot_elems:][:slot_elems]
            for e in range(unit_steps):
                s = uu * unit_steps + e
                k = 0 if s < 4 else 1 + (s - 4) // 2
                base = x_off + s * plane if s < 4 else act_off[k - 1] + (s - 4) % 2 * _pix(k) * 16
                kcols, d = _win(k)[1], j - 1 - k
                for tap in range(9):
                    a = k16_a_fragments(smem, base,
                                        (oy + tap // 3 + d) * kcols + ox + tap % 3 + d)
                    for half in range(cout // 32):
                        acc[:, 32 * half:32 * (half + 1)] += a @ bf16_b_operand(
                            slot, e, tap, cout, n=32, start=512 * half)
            u += 1
        # epilogue, in float32
        v = acc[:npix].astype(np.float32) + np.asarray(biases[b_off:b_off + cout], np.float32)
        b_off += cout
        ogy = ty0 - (MARGIN - j) + oy[:npix]
        ogx = tx0 - (MARGIN - j) + ox[:npix]
        keep = (ogy >= 0) & (ogy < h) & (ogx >= 0) & (ogx < w)
        if j == 5:
            return v.reshape(TH, TW, F), keep.reshape(TH, TW)
        val = np.where(keep[:, None], np.where(v >= 0, v, np.float32(0.2) * v), np.float32(0))
        co = np.arange(G)
        dst = act_off[j - 1] + ((co >> 4) * npix + r[:npix, None]) * 16 + (co & 15)
        smem[dst] = _bf16_of(val.astype(np.float32))
        region = smem[act_off[j - 1]:act_off[j - 1] + npix * G]
        assert not np.isnan(_bf16_value(region)).any(), "a_j storage not fully written"
    raise AssertionError("unreachable")


# --- csrc/deform_tail.cu ----------------------------------------------------

REACH = 2  # largest clamp the tail kernels' windows cover
K2_TILE, K2_BLK, K2_GROUP_STEPS = 16, 16, 2
K3_TH, K3_TW = 8, 32


def _window(img, y0, x0, wh, ww):
    """img's window of wh x ww pixels from (y0 - 3, x0 - 3), zero outside."""
    h, w = img.shape[:2]
    gy, iny = _inside(y0 - REACH - 1, wh, h)
    gx, inx = _inside(x0 - REACH - 1, ww, w)
    win = np.zeros((wh, ww) + img.shape[2:], img.dtype)
    yy, xx = np.meshgrid(gy, gx, indexing="ij")
    m = iny[:, None] & inx[None, :]
    win[m] = img[yy[m], xx[m]]
    return win


def _tap_corners(o, t, clamp, ly, lx, win_w):
    """Tap t's clamped corners of the pixels at tile positions (ly, lx):
    the window index of the base corner and the four corner weights, in the
    kernels' float32 arithmetic."""
    dy = np.clip(o[..., t], -clamp, clamp).astype(np.float32)
    dx = np.clip(o[..., 9 + t], -clamp, clamp).astype(np.float32)
    iy, ix = np.floor(dy), np.floor(dx)
    fy, fx = dy - iy, dx - ix
    one = np.float32(1)
    base = (ly + t // 3 + iy.astype(int) + REACH) * win_w + lx + t % 3 + ix.astype(int) + REACH
    return base, ((one - fy) * (one - fx), (one - fy) * fx, fy * (one - fx), fy * fx)


def emulate_k2_tc(x, off, w_tc, bias, clamp, lrelu, passes=3):
    """K2 (``lrelu``) or K7: per 16 x 16 tile, the 23 x 23 window as
    [16-channel block][pixel][16]; per tap, each pixel's four corners
    blended in float32 and split into hi/lo; k8 step s = 2 b + e takes slot
    k <- channel 16 b + 4 (k % 4) + 2 e + k // 4 of the samples and B from
    ``w_tc`` (``pack_deform64_weight_tc``) read as the wgmma descriptor does;
    each group of two steps (one window block) summed into a fresh partial
    sum.
    ``passes`` 1 keeps hi.hi only, a single TF32 pass."""
    n, h, w, c = x.shape
    win_w = K2_TILE + 2 * (REACH + 1) + 1
    # [tap][hi|lo][step][n/8][k/4][n%8][k%4] -> [tap][hi|lo][step][k][n]
    b = (np.asarray(w_tc, np.float32).reshape(9, 2, 8, 8, 2, 8, 4)
         .transpose(0, 1, 2, 4, 6, 3, 5).reshape(9, 2, 8, 8, c).astype(np.float64))
    k = np.arange(8)
    out = np.zeros((n, h, w, c), np.float32)
    ly, lx = np.meshgrid(np.arange(K2_TILE), np.arange(K2_TILE), indexing="ij")
    for i in range(n):
        for y0 in range(0, h, K2_TILE):
            for x0 in range(0, w, K2_TILE):
                win = _window(np.asarray(x[i], np.float32), y0, x0, win_w, win_w)
                blocks = win.reshape(win_w * win_w, c // K2_BLK, K2_BLK).transpose(1, 0, 2)
                # lanes past the image read the offsets of its last row / column
                o = off[i, np.minimum(y0 + ly, h - 1), np.minimum(x0 + lx, w - 1)]
                acc = np.zeros((K2_TILE, K2_TILE, c))
                for t in range(9):
                    base, cw = _tap_corners(o, t, clamp, ly, lx, win_w)
                    samp = sum(wt[..., None, None] * blocks[:, base + d].transpose(1, 2, 0, 3)
                               for wt, d in zip(cw, (0, 1, win_w, win_w + 1)))
                    # samp: (16, 16, block, 16) float32 -> A of each k8 step
                    for g0 in range(0, 8, K2_GROUP_STEPS):
                        part = np.zeros_like(acc)
                        for s in range(g0, g0 + K2_GROUP_STEPS):
                            a = samp[:, :, s // 2, 4 * (k % 4) + 2 * (s % 2) + k // 4]
                            ah, al = split_tf32(a)
                            ah, al = ah.astype(np.float64), al.astype(np.float64)
                            part += ah @ b[t, 0, s]
                            if passes == 3:
                                part += al @ b[t, 0, s] + ah @ b[t, 1, s]
                        acc += part
                (ys, ny), (xs, nx) = _tile_span(y0, h, K2_TILE), _tile_span(x0, w, K2_TILE)
                v = acc[:ny, :nx].astype(np.float32) + np.asarray(bias, np.float32)
                out[i, ys, xs] = np.where(v >= 0, v, np.float32(0.2) * v) if lrelu else v
    return out


def emulate_k3_window(z, off, bias, clamp):
    """K3: per 8 x 32 tile, the 15 x 39 window of the nine tap fields; each
    pixel's 36 corners read from it, summed over the taps, plus the bias."""
    n, h, w, taps = z.shape
    wh, ww = K3_TH + 2 * (REACH + 1) + 1, K3_TW + 2 * (REACH + 1) + 1
    out = np.zeros((n, h, w, 1))
    ly, lx = np.meshgrid(np.arange(K3_TH), np.arange(K3_TW), indexing="ij")
    for i in range(n):
        for y0 in range(0, h, K3_TH):
            for x0 in range(0, w, K3_TW):
                win = _window(np.asarray(z[i], np.float32), y0, x0, wh, ww).reshape(wh * ww, taps)
                (ys, ny), (xs, nx) = _tile_span(y0, h, K3_TH), _tile_span(x0, w, K3_TW)
                o = np.zeros((K3_TH, K3_TW, 2 * taps), np.float32)
                o[:ny, :nx] = off[i, ys, xs]
                acc = np.zeros((K3_TH, K3_TW))
                for t in range(taps):
                    base, cw = _tap_corners(o, t, clamp, ly, lx, ww)
                    for wt, d in zip(cw, (0, 1, ww, ww + 1)):
                        acc += wt * win[base + d, t].astype(np.float64)
                out[i, ys, xs, 0] = (acc + bias[0])[:ny, :nx]
    return out


# --- csrc/deform_zform.cu ---------------------------------------------------

K9_TH, K9_TW = 7, 16  # C_out 64 and 16
K9_XH, K9_XW = K9_TH + 2 * (REACH + 1) + 1, K9_TW + 2 * (REACH + 1) + 1  # 14 x 23
K9_ZH, K9_ZW = K9_TH + 2 * REACH + 1, K9_TW + 2 * REACH + 1  # 12 x 21
K9_M = 256  # four warpgroups' 64-row blocks
K9_1TH, K9_1TW = 32, 32  # C_out 1
K9_1XH, K9_1XW = K9_1TH + 2 * (REACH + 1) + 1, K9_1TW + 2 * (REACH + 1) + 1  # 39 x 39


def emulate_k9(x, off, w_packed, bias, clamp, passes=3):
    """K9 with C_out = len(bias). For C_out 64 and 16, ``w_packed`` is
    ``pack_deform64_weight_tc``'s flat B: per 7 x 16 tile the 14 x 23 window
    as [16-channel block][pixel][16], zero outside the image and past C_in;
    per tap the 12 x 21 positions its corners can reach as M rows 0..251 of
    256 (rows past 251 read position 251 and are dropped), k8 step
    s = 2 b + e taking slot k <- channel 16 b + 4 (k % 4) + 2 e + k // 4 of
    the raw window split into TF32 hi/lo, a partial sum per window block,
    z_t rounded to float32 as the kernel stores it; then each pixel's four
    corners of z_t. ``passes`` 1 keeps hi.hi only, a single TF32 pass. For
    C_out 1, ``w_packed`` is the (C_in, 9) tap matrix and the fp32
    projection is emulated in float64 (``_emulate_k9_fields``)."""
    n, h, w, cin = x.shape
    cout = len(bias)
    if cout == 1:
        return _emulate_k9_fields(x, off, w_packed, bias, clamp)
    blocks = -(-cin // 16)
    steps = 2 * blocks
    # [tap][hi|lo][step][n/8][k/4][n%8][k%4] -> [tap][hi|lo][step][k][n]
    b = (np.asarray(w_packed, np.float32).reshape(9, 2, steps, cout // 8, 2, 8, 4)
         .transpose(0, 1, 2, 4, 6, 3, 5).reshape(9, 2, steps, 8, cout).astype(np.float64))
    p = np.minimum(np.arange(K9_M), K9_ZH * K9_ZW - 1)
    xpos = (p // K9_ZW) * K9_XW + p % K9_ZW  # window pixel of M row r at tap 0
    k = np.arange(8)
    xpad = np.zeros((n, h, w, 16 * blocks), np.float32)
    xpad[..., :cin] = x
    out = np.zeros((n, h, w, cout), np.float32)
    ly, lx = np.meshgrid(np.arange(K9_TH), np.arange(K9_TW), indexing="ij")
    for i in range(n):
        for y0 in range(0, h, K9_TH):
            for x0 in range(0, w, K9_TW):
                win = _window(xpad[i], y0, x0, K9_XH, K9_XW)
                wblk = win.reshape(K9_XH * K9_XW, blocks, 16).transpose(1, 0, 2)
                # lanes past the image read the offsets of its last row / column
                o = off[i, np.minimum(y0 + ly, h - 1), np.minimum(x0 + lx, w - 1)]
                acc = np.zeros((K9_TH, K9_TW, cout))
                for t in range(9):
                    rows = xpos + (t // 3) * K9_XW + t % 3
                    z = np.zeros((K9_M, cout))
                    for blk in range(blocks):
                        part = np.zeros_like(z)
                        for e in range(2):
                            s = 2 * blk + e
                            a = wblk[blk][rows][:, 4 * (k % 4) + 2 * e + k // 4]
                            ah, al = (v.astype(np.float64) for v in split_tf32(a))
                            part += ah @ b[t, 0, s]
                            if passes == 3:
                                part += al @ b[t, 0, s] + ah @ b[t, 1, s]
                        z += part
                    zt = z[:K9_ZH * K9_ZW].astype(np.float32).astype(np.float64)
                    # z_t's window is the x window shifted by the tap
                    base, cw = _tap_corners(o, t, clamp, ly, lx, K9_ZW)
                    base = base - (t // 3) * K9_ZW - t % 3
                    for wt, d in zip(cw, (0, 1, K9_ZW, K9_ZW + 1)):
                        acc += wt[..., None] * zt[base + d]
                (ys, ny), (xs, nx) = _tile_span(y0, h, K9_TH), _tile_span(x0, w, K9_TW)
                out[i, ys, xs] = acc[:ny, :nx].astype(np.float32) + np.asarray(bias, np.float32)
    return out


def _emulate_k9_fields(x, off, w_tap, bias, clamp):
    """K9 at C_out 1: per 32 x 32 tile, the 39 x 39 window staged one
    8-channel chunk at a time as [4-channel group][pixel][4] (zero outside
    the image and past C_in) and projected onto the nine tap fields with the
    weights as [channel][12] (zero past C_in and past tap 8), the fields
    stored [pixel][9]; then K3's sampling of them with the tile's offsets
    (zero past the image)."""
    n, h, w, cin = x.shape
    chunks = -(-cin // 8)
    npix = K9_1XH * K9_1XW
    s_w = np.zeros((8 * chunks, 12))
    s_w[:cin, :9] = np.asarray(w_tap, np.float32).reshape(cin, 9)
    out = np.zeros((n, h, w, 1))
    ly, lx = np.meshgrid(np.arange(K9_1TH), np.arange(K9_1TW), indexing="ij")
    p = np.arange(npix)
    for i in range(n):
        for y0 in range(0, h, K9_1TH):
            for x0 in range(0, w, K9_1TW):
                gy, gx = y0 - REACH - 1 + p // K9_1XW, x0 - REACH - 1 + p % K9_1XW
                inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
                z = np.zeros((npix, 9))
                for chunk in range(chunks):
                    flat = np.zeros(2 * npix * 4, np.float32)  # [c4][pixel][4]
                    for c4l in range(2):
                        c4 = 2 * chunk + c4l
                        if 4 * c4 >= cin:
                            continue
                        vals = np.zeros((npix, 4), np.float32)
                        vals[inside] = x[i, gy[inside], gx[inside], 4 * c4:4 * c4 + 4]
                        flat[(c4l * npix + p[:, None]) * 4 + np.arange(4)] = vals
                    for c4l in range(2):
                        xv = flat[(c4l * npix + p[:, None]) * 4 + np.arange(4)]
                        z += xv.astype(np.float64) @ s_w[8 * chunk + 4 * c4l:][:4, :9]
                fields = z.astype(np.float32).reshape(-1)  # [pixel][9]
                (ys, ny), (xs, nx) = _tile_span(y0, h, K9_1TH), _tile_span(x0, w, K9_1TW)
                o = np.zeros((K9_1TH, K9_1TW, 18), np.float32)
                o[:ny, :nx] = off[i, ys, xs]
                acc = np.zeros((K9_1TH, K9_1TW))
                for t in range(9):
                    base, cw = _tap_corners(o, t, clamp, ly, lx, K9_1XW)
                    for wt, d in zip(cw, (0, 1, K9_1XW, K9_1XW + 1)):
                        acc += wt * fields[(base + d) * 9 + t].astype(np.float64)
                out[i, ys, xs, 0] = (acc + bias[0])[:ny, :nx]
    return out
