"""The windowed schedule of ``csrc/durbin.cu``'s long route, emulated on
the CPU in float64 with its window and tile widths as arguments.

The long route (T above the one-block kernels' range) runs the recursion
a window of ``nb`` steps a launch.  Each warp owns ``span`` consecutive
lags: it recurs the window's coefficients itself from the front lags
``[k0, k0 + nb)`` and the carried denominator, then applies the window's
steps to its lags, of which the top ``span - nb`` (forward) or the bottom
``span - nb`` (reverse) come out exact and are written back.  The reverse
splits each window's cotangent into the part that comes in from later
windows, which every tile carries back through the window on its own
lags, and the part the window's coefficients inject at its front lags,
which one warp carries: each step's coefficient cotangent is the tiles'
partial sums plus the front's.  These functions do the same, tile by
tile, with ``torch``'s vector ops in place of the lanes, so the CPU tests
can hold the schedule against ``ops.durbin``'s plain versions at widths
small enough for many windows and tiles.
"""
import torch
import torch.nn.functional as F

from gpvae_tpu_torch.ops.durbin import clamp_alpha


def _gather(v, lags, t):
    """``v [N, T]`` at ``lags`` (0 outside ``[0, T)``)."""
    inside = (lags >= 0) & (lags < t)
    return torch.where(inside, v[:, lags.clamp(0, t - 1)],
                       torch.zeros((), dtype=v.dtype))


def forward(rho, nb, span, save=False):
    """``durbin_plain(rho, save)``'s outputs by the long route's schedule."""
    n, t1 = rho.shape
    t = t1 + 1
    out_w = span - nb
    tiles = -(-t // out_w)
    one = torch.ones(n, 1, dtype=rho.dtype)
    x_buf = torch.cat([one, rho], 1)
    z_buf = x_buf.clone()
    den = torch.ones(n, dtype=rho.dtype)
    alpha = torch.zeros(n, t1, dtype=rho.dtype)
    steps = torch.zeros(n, 4, t1, dtype=rho.dtype)
    last = torch.zeros(n, 2, t, dtype=rho.dtype)
    lane = torch.arange(nb)
    for k0 in range(1, t, nb):
        nw = min(nb, t - k0)
        # the front: each warp's own copy of the window's coefficients
        front = k0 + lane
        s, tt = _gather(x_buf, front, t), _gather(z_buf, front, t)
        al = torch.zeros(n, nb, dtype=rho.dtype)
        for j in range(nw):
            num = s[:, j]
            a = clamp_alpha(-num / den)
            al[:, j] = a
            steps[:, 1, k0 - 1 + j], steps[:, 2, k0 - 1 + j] = num, den
            tprev = F.pad(tt[:, :-1], (1, 0))
            later = lane > j
            s, tt = (torch.where(later, s + a[:, None] * tprev, s),
                     torch.where(later, tprev + a[:, None] * s, tt))
            den = den + a * num
        alpha[:, k0 - 1:k0 - 1 + nw] = al[:, :nw]
        # the tiles: span lags, the bottom nb a halo
        x_new, z_new = x_buf.clone(), z_buf.clone()
        for tile in range(tiles):
            m0 = tile * out_w
            lags = m0 - nb + torch.arange(span)
            x, z = _gather(x_buf, lags, t), _gather(z_buf, lags, t)
            mine = (lags >= m0) & (lags < min(m0 + out_w, t))
            for j in range(nw):
                k = k0 + j
                a = al[:, j:j + 1]
                w = F.pad(z[:, :-1], (1, 0))
                x0 = torch.where(lags == k, torch.zeros(()), x)
                top = mine & (lags == t - 1)
                if top.any():
                    steps[:, 3, k - 1] = z[:, top][:, 0]
                if k == t1:
                    last[:, 0, lags[mine]] = x0[:, mine]
                    last[:, 1, lags[mine]] = w[:, mine]
                x, z = x0 + a * w, w + a * x0
            x_new[:, lags[mine]], z_new[:, lags[mine]] = x[:, mine], z[:, mine]
        x_buf, z_buf = x_new, z_new
    steps[:, 0] = alpha
    l1p = torch.log1p(-alpha * alpha)
    weight = t - torch.arange(1, t, dtype=rho.dtype)
    outs = ((weight * l1p).sum(-1), x_buf[:, 1:], torch.exp(l1p.sum(-1)))
    return (*outs, (steps, last)) if save else outs


def backward(steps, last, g_sum, g_y, g_e, nb, span):
    """``durbin_bwd_plain``'s gradient by the long route's schedule."""
    alpha, num, den, top = steps.unbind(1)
    n, t1 = alpha.shape
    t = t1 + 1
    out_w = span - nb
    tiles = -(-t // out_w)
    opts = dict(dtype=steps.dtype)
    lim = 1.0 - 8 * torch.finfo(steps.dtype).eps
    raw = -num / den
    rden = torch.where((raw >= -lim) & (raw <= lim), 1.0 / den,
                       torch.zeros_like(den))
    inv = 1.0 / (1.0 - alpha * alpha)
    gee = (torch.zeros(n, **opts) if g_e is None
           else g_e * torch.exp(torch.log1p(-alpha * alpha).sum(-1)))
    gs = torch.zeros(n, **opts) if g_sum is None else g_sum
    coef = -2.0 * alpha * inv * ((t - torch.arange(1, t, **opts)) * gs[:, None]
                                 + gee[:, None])
    x_buf = torch.zeros(n, t, **opts)
    z_buf = torch.zeros(n, t, **opts)
    xb_buf = torch.zeros(n, t, **opts)
    if g_y is not None:
        xb_buf[:, 1:] = g_y
    zb_buf = torch.zeros(n, t, **opts)
    extra = torch.zeros(n, **opts)
    lane = torch.arange(nb)
    for k0 in reversed(range(1, t, nb)):
        nw = min(nb, t - k0)
        part = torch.zeros(n, tiles, nb, **opts)
        front_in = torch.zeros(n, nb, 2, nb, **opts)  # step j, (X, W), lane
        new = [b.clone() for b in (x_buf, z_buf, xb_buf, zb_buf)]
        # the tiles: span lags, the top nb a halo, the part of the
        # cotangent that came in from later windows
        for tile in range(tiles):
            m0 = tile * out_w
            lags = m0 + torch.arange(span)
            x, z, xb, zb = (_gather(b, lags, t)
                            for b in (x_buf, z_buf, xb_buf, zb_buf))
            mine = lags < min(m0 + out_w, t)
            at_front = mine & (lags >= k0) & (lags < k0 + nb)
            for j in reversed(range(nw)):
                k = k0 + j
                al = alpha[:, k - 1:k]
                if k == t1:
                    xi, w = _gather(last[:, 0], lags, t), _gather(last[:, 1],
                                                                  lags, t)
                else:
                    iv = inv[:, k - 1:k]
                    xi, w = (x - al * z) * iv, (z - al * x) * iv
                part[:, tile, j] = torch.where(mine, xb * w + zb * xi,
                                               torch.zeros(())).sum(-1)
                front_in[:, j, 0, lags[at_front] - k0] = xi[:, at_front]
                front_in[:, j, 1, lags[at_front] - k0] = w[:, at_front]
                xbi, wb = xb + al * zb, zb + al * xb
                x, xb = xi, xbi
                z, zb = F.pad(w[:, 1:], (0, 1)), F.pad(wb[:, 1:], (0, 1))
                x = torch.where(lags == k, num[:, k - 1:k], x)
                xb = torch.where(lags == k, torch.zeros(()), xb)
                z = torch.where(lags == t - 1, top[:, k - 1:k], z)
                zb = torch.where(lags == t - 1, torch.zeros(()), zb)
            for buf, v in zip(new, (x, z, xb, zb)):
                buf[:, lags[mine]] = v[:, mine]
        x_buf, z_buf, xb_buf, zb_buf = new
        # the front: what the window's coefficients inject, on its nb lags
        tail = part.sum(1)
        xb = torch.zeros(n, nb, **opts)
        zb = torch.zeros(n, nb, **opts)
        for j in reversed(range(nw)):
            k = k0 + j
            al = alpha[:, k - 1]
            xi, w = front_in[:, j, 0], front_in[:, j, 1]
            abar = ((xb * w + zb * xi).sum(-1) + tail[:, j]
                    + extra * num[:, k - 1] + coef[:, k - 1])
            g = abar * rden[:, k - 1]
            xbi, wb = xb + al[:, None] * zb, zb + al[:, None] * xb
            xb, zb = xbi, F.pad(wb[:, 1:], (0, 1))
            xb = torch.where(lane == j, (al * extra - g)[:, None], xb)
            extra = extra - g * al
        front = k0 + lane
        inside = front < t
        xb_buf[:, front[inside]] += xb[:, inside]
        zb_buf[:, front[inside]] += zb[:, inside]
    return xb_buf[:, 1:] + zb_buf[:, 1:]
