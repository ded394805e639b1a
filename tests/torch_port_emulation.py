"""numpy (float64) emulations of the algorithms of the port's tile-local CUDA
kernels, for the CPU tests: the kernels themselves only run on the card
(``chip_smoke.py``), so the tests hold these step-for-step copies of their
index arithmetic against the plain PyTorch versions.

- ``dense_block_tile``: ``csrc/rdb_tile.cuh`` (one 8 x 8 tile of a dense
  block, intermediates on shrinking windows, zero outside the image);
- ``emulate_k6``: ``csrc/rdb_banded.cu`` (one tile per block);
- ``emulate_k5``: ``csrc/rrdb_sweep.cu`` (the wavefront sweep with its two
  4-slot band rings, two bands of lag between dense blocks);
- ``emulate_k9``: ``csrc/deform_zform.cu`` (per-tap projection of an 8 x 16
  tile's window, then four-corner sampling).
"""

import numpy as np

F, G = 64, 32
T, MARGIN = 8, 5  # tile side (K5's band) and input halo
SLOTS, LAG = 4, 2


def _stage_weights(w_packed, b_packed):
    """The five stages' [ci][tap][co] matrices and biases from the packed
    [C_out/32][C_in][9][32] layout."""
    out, off, boff = [], 0, 0
    for j in range(5):
        cin, cout = F + G * j, G if j < 4 else F
        wp = w_packed[off : off + cin * 9 * cout].reshape(cout // 32, cin, 9, 32)
        out.append((wp.transpose(1, 2, 0, 3).reshape(cin, 9, cout),
                    b_packed[boff : boff + cout]))
        off += cin * 9 * cout
        boff += cout
    return out


def _inside(lo, n, limit):
    idx = lo + np.arange(n)
    return idx, (idx >= 0) & (idx < limit)


def dense_block_tile(load, stages, ty0, tx0, h, w):
    """One tile: ``load(gy, gx)`` gives the block input at in-image pixels
    (index arrays). Returns (conv5 + b5, the input at the tile) as (8, 8, 64)
    arrays over the whole tile, in-image or not."""
    side = T + 2 * MARGIN
    gy, iny = _inside(ty0 - MARGIN, side, h)
    gx, inx = _inside(tx0 - MARGIN, side, w)
    win = np.zeros((side, side, F))
    yy, xx = np.meshgrid(gy, gx, indexing="ij")
    m = iny[:, None] & inx[None, :]
    win[m] = load(yy[m], xx[m])
    srcs = [win]
    for j in range(1, 6):
        s = side - 2 * j  # this stage's output side
        wmat, b = stages[j - 1]
        # every source cropped to this stage's input window (side s + 2)
        inp = np.concatenate(
            [src[j - 1 - k : j - 1 - k + s + 2, j - 1 - k : j - 1 - k + s + 2]
             for k, src in enumerate(srcs)], axis=-1)
        acc = sum(inp[ky : ky + s, kx : kx + s] @ wmat[:, 3 * ky + kx]
                  for ky in range(3) for kx in range(3)) + b
        if j == 5:
            return acc, win[MARGIN : MARGIN + T, MARGIN : MARGIN + T]
        _, oy = _inside(ty0 - (MARGIN - j), s, h)
        _, ox = _inside(tx0 - (MARGIN - j), s, w)
        a = np.where(acc >= 0, acc, 0.2 * acc)
        srcs.append(np.where((oy[:, None] & ox[None, :])[..., None], a, 0.0))
    raise AssertionError("unreachable")


def _tile_span(t0, limit, size=T):
    return slice(t0, min(t0 + size, limit)), min(t0 + size, limit) - t0


def emulate_k6(x, w_packed, b_packed, scaling):
    """csrc/rdb_banded.cu: every 8 x 8 tile from its own input window."""
    n, h, w, _ = x.shape
    stages = _stage_weights(w_packed, b_packed)
    out = np.full(x.shape, np.nan)
    for i in range(n):
        for ty0 in range(0, h, T):
            for tx0 in range(0, w, T):
                v, xc = dense_block_tile(lambda gy, gx: x[i, gy, gx], stages, ty0, tx0,
                                         h, w)
                (ys, ny), (xs, nx) = _tile_span(ty0, h), _tile_span(tx0, w)
                out[i, ys, xs] = (xc + scaling * v)[:ny, :nx]
    return out


def emulate_k5(x, w_packed, b_packed, scaling):
    """csrc/rrdb_sweep.cu: step s runs RDB1 band s, RDB2 band s-2 and RDB3
    band s-4, every tile of a step reading the state before the step; the
    block outputs live in 4-slot rings that start as NaN, so a read of a slot
    that holds no band yet poisons the result. Asserts that no step writes a
    ring slot it also reads."""
    n, h, w, _ = x.shape
    bands = -(-h // T)
    block = sum(9 * (F + G * j) * (G if j < 4 else F) for j in range(5))
    stages = [_stage_weights(w_packed[p * block : (p + 1) * block],
                             b_packed[p * (F + 4 * G) : (p + 1) * (F + 4 * G)])
              for p in range(3)]
    rings = [np.full((SLOTS, n, T, w, F), np.nan) for _ in range(2)]
    out = np.full(x.shape, np.nan)
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
                    reads.update((p - 1, int(sl)) for sl in np.unique(gy // T % SLOTS))
                    return before[p - 1][gy // T % SLOTS, i, gy % T, gx]

                for tx0 in range(0, w, T):
                    v, a = dense_block_tile(load, stages[p], band * T, tx0, h, w)
                    (ys, ny), (xs, nx) = _tile_span(band * T, h), _tile_span(tx0, w)
                    t = (a + scaling * v)[:ny, :nx]
                    if p < 2:
                        writes.add((p, band % SLOTS))
                        rings[p][band % SLOTS, i, :ny, xs] = t
                    else:
                        out[i, ys, xs] = x[i, ys, xs] + scaling * t
        assert not reads & writes, f"step {step} reads and writes ring slots {reads & writes}"
    return out


def emulate_k9(x, off, w_packed, bias, clamp, th=8, tw=16, reach=2):
    """csrc/deform_zform.cu: per output tile, the input window with 3 px of
    reach (zero outside the image); per tap, its 13 x 21 projection window
    z_t = x W_t, then the four clamped bilinear corners of each pixel's
    sample read from it."""
    n, h, w, cin = x.shape
    taps, cout = w_packed.shape[0] // cin, w_packed.shape[1]
    wt = w_packed.reshape(taps, cin, cout)
    xh, xw = th + 2 * (reach + 1) + 1, tw + 2 * (reach + 1) + 1
    zh, zw = th + 2 * reach + 1, tw + 2 * reach + 1
    out = np.zeros((n, h, w, cout))
    for i in range(n):
        for y0 in range(0, h, th):
            for x0 in range(0, w, tw):
                gy, iny = _inside(y0 - reach - 1, xh, h)
                gx, inx = _inside(x0 - reach - 1, xw, w)
                xwin = np.zeros((xh, xw, cin))
                yy, xx = np.meshgrid(gy, gx, indexing="ij")
                m = iny[:, None] & inx[None, :]
                xwin[m] = x[i, yy[m], xx[m]]
                (ys, ny), (xs, nx) = _tile_span(y0, h, th), _tile_span(x0, w, tw)
                ly, lx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
                o = off[i, ys, xs]
                acc = np.zeros((ny, nx, cout))
                for t in range(taps):
                    u, v = divmod(t, 3)
                    z = xwin[u : u + zh, v : v + zw] @ wt[t]
                    dy = np.clip(o[..., t], -clamp, clamp)
                    dx = np.clip(o[..., taps + t], -clamp, clamp)
                    iy, ix = np.floor(dy), np.floor(dx)
                    fy, fx = (dy - iy)[..., None], (dx - ix)[..., None]
                    zr = ly + reach + iy.astype(int)
                    zc = lx + reach + ix.astype(int)
                    acc += ((1 - fy) * (1 - fx) * z[zr, zc] + (1 - fy) * fx * z[zr, zc + 1]
                            + fy * (1 - fx) * z[zr + 1, zc] + fy * fx * z[zr + 1, zc + 1])
                out[i, ys, xs] = acc + bias
    return out
