"""Plain PyTorch versions of the port's CUDA kernels.

The plain versions of ``pack_tril`` and ``unpack_tril`` are those of
:mod:`repro_torch.core.packing`.

Each function computes what its kernel computes, with the kernel's
algorithm written as tensor operations (blocked loops where the kernel
walks tiles), on any device.  The wrappers call these for CPU tensors, the
CPU tests hold them against the JAX package, and ``chip_smoke.py`` holds
each kernel against its plain version on the card.  They are oracles, not
yardsticks of speed.

``compute_dtype`` (bf16 under the mixed policies) gives the plain versions
of the mixed-precision variants: the operands of every product the kernel
runs on the tensor cores are rounded to it (:func:`_rounded`) and
multiplied at the state's dtype, where a product of two bf16 values is
exact, so plain and kernel differ only in the order of the fp32 sums.
Factorizations and inversions stay at the state's dtype.

The diagonal-tile helpers (:func:`dense_diag_inverses`,
:func:`packed_diag_inverses`, :func:`interp_diag_inverses`) serve the
plain versions, as the JAX package computes the inverses outside Pallas.
The three cluster-solve kernels (the dense trsm, ``interp_solve`` and the
packed trsm) form theirs in their prologue; :func:`invert_lower_tile` is
that inversion, and :func:`solve_right_looking` (with
:func:`cluster_plan`) the kernels' cluster order of the substitution, for
the tests.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import packing

__all__ = ["cholesky_blocked", "cholesky_blocked_stored", "factor_diag_tile",
           "solve_lower_blocked", "solve_lower_blocked_stored",
           "solve_lower_packed", "solve_packed", "interp_solve",
           "interp_solve_stored", "horner_stored", "interp_factors",
           "dense_diag_inverses",
           "packed_diag_inverses", "interp_diag_inverses",
           "invert_lower_tile", "CLUSTER_SIZES", "cluster_plan",
           "solve_right_looking",
           "ssm_scan", "mamba_scan", "mamba_scan_bwd", "causal_conv1d",
           "causal_conv1d_silu", "causal_conv1d_silu_bwd"]


def _rounded(t: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``t`` rounded to ``compute_dtype`` (to nearest even) and back to its
    own dtype: an operand as the tensor cores read it.  ``t`` itself when
    ``compute_dtype`` is None."""
    return t if compute_dtype is None else t.to(compute_dtype).to(t.dtype)


def _identity_padded(a: torch.Tensor, block: int) -> torch.Tensor:
    """Copy of ``a`` (…, h, h) padded to a tile multiple, identity on the
    padded diagonal (keeps the padded factor finite and nonsingular)."""
    h = a.shape[-1]
    hp = packing.num_tiles(h, block) * block
    out = a.new_zeros((*a.shape[:-2], hp, hp))
    out[..., :h, :h] = a
    idx = torch.arange(h, hp, device=a.device)
    out[..., idx, idx] = 1
    return out


def _potf2(a: torch.Tensor) -> torch.Tensor:
    """Unblocked Cholesky of (…, B, B) tiles (lower triangle read)."""
    a = a.clone()
    for k in range(a.shape[-1]):
        piv = torch.sqrt(a[..., k, k])
        col = a[..., k + 1:, k] / piv[..., None]
        a[..., k, k] = piv
        a[..., k + 1:, k] = col
        a[..., k + 1:, k + 1:] -= col[..., :, None] * col[..., None, :]
    return torch.tril(a)


def _inv_lower(l: torch.Tensor) -> torch.Tensor:
    """X with L X = I by row-wise forward substitution."""
    b = l.shape[-1]
    x = torch.zeros_like(l)
    for k in range(b):
        s = (l[..., k:k + 1, :k] @ x[..., :k, :])[..., 0, :]
        e = torch.zeros(b, dtype=l.dtype, device=l.device)
        e[k] = 1
        x[..., k, :] = (e - s) / l[..., k, k, None]
    return x


def factor_diag_tile(a: torch.Tensor, nb: int = 16
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The diagonal step of ``csrc/chol_blocked.cu`` in the kernel's order:
    SPD tiles (…, B, B) (lower triangle read) → (L, X = L⁻¹), both lower.

    Per ``nb``-column sub-block p: potf2 of A_pp and its inverse X_pp, the
    rows below as L_ip = A_ip X_ppᵀ, then A_ij −= L_ip L_jpᵀ.  Then the
    inverse block row by block row, X_ij = −X_ii Σ_{k=j}^{i−1} L_ik X_kj.
    Same result as :func:`_potf2` and :func:`_inv_lower` on the whole tile
    up to rounding; used by the tests to hold the kernel's algebra to them.
    """
    b = a.shape[-1]
    if b % nb:
        raise ValueError(f"factor_diag_tile: tile {b} is not a multiple of "
                         f"nb={nb}")
    ns = b // nb
    sub = [slice(p * nb, (p + 1) * nb) for p in range(ns)]
    l = a.clone()
    xd = []
    for p in range(ns):
        lpp = _potf2(l[..., sub[p], sub[p]])
        xd.append(_inv_lower(lpp))
        l[..., sub[p], sub[p]] = lpp
        below = slice((p + 1) * nb, b)
        lip = l[..., below, sub[p]] @ xd[p].mT
        l[..., below, sub[p]] = lip
        l[..., below, below] -= lip @ lip.mT
    l = torch.tril(l)
    x = torch.zeros_like(l)
    for i in range(ns):
        x[..., sub[i], sub[i]] = xd[i]
        for j in range(i):
            t = l[..., sub[i], j * nb:i * nb] @ x[..., j * nb:i * nb, sub[j]]
            x[..., sub[i], sub[j]] = -xd[i] @ t
    return l, x


def cholesky_blocked(a: torch.Tensor, block: int,
                     compute_dtype=None) -> torch.Tensor:
    """Blocked right-looking Cholesky of SPD (…, h, h) → lower (…, h, h):
    per tile column, potf2 and inversion of the diagonal tile, the panel as
    a product with the inverse, then the trailing update.  With
    ``compute_dtype`` the panel's operands (A_i1 and the inverse) and the
    trailing update's (the panel W) are rounded to it, as at
    ``src/repro/kernels/chol_blocked.py:80-82, 98-100``; the diagonal
    factor and its inverse stay at ``a``'s dtype."""
    h = a.shape[-1]
    nt = packing.num_tiles(h, block)
    out = _identity_padded(a, block)
    for j in range(nt):
        lo, hi = j * block, (j + 1) * block
        l11 = _potf2(out[..., lo:hi, lo:hi])
        out[..., lo:hi, lo:hi] = l11
        if j + 1 < nt:
            sub = (_rounded(out[..., hi:, lo:hi], compute_dtype)
                   @ _rounded(_inv_lower(l11), compute_dtype).mT)
            out[..., hi:, lo:hi] = sub
            w = _rounded(sub, compute_dtype)
            out[..., hi:, hi:] -= w @ w.mT
    return torch.tril(out[..., :h, :h])


def cholesky_blocked_stored(a: torch.Tensor, block: int,
                            compute_dtype) -> torch.Tensor:
    """:func:`cholesky_blocked` with ``compute_dtype`` products in the
    dataflow of the kernel's wgmma design (``csrc/chol_blocked.cu``): each
    operand rounded once, where it is stored, and kept in
    ``compute_dtype`` — the diagonal inverse as the diagonal step writes
    it, A_i1 as the panel job stages it, the panel W as the bf16 copy the
    panel job writes beside the unrounded W it puts into the factor — then
    the trailing update one lower tile pair a job, the next diagonal tile
    (pair 0) left to the next diagonal step, which applies it before its
    factorization.  A value rounded once where it is stored is the operand
    that rounding it wherever it is read gives, so this is
    :func:`cholesky_blocked` (``compute_dtype``) value for value."""
    h = a.shape[-1]
    nt = packing.num_tiles(h, block)
    out = _identity_padded(a, block)
    tile = [slice(k * block, (k + 1) * block) for k in range(nt)]
    wb = None                      # the bf16 panel of the previous column
    for j in range(nt):
        d = out[..., tile[j], tile[j]]
        if wb is not None:         # the look-ahead: pair 0, W0 W0ᵀ
            w0 = wb[0].to(out.dtype)
            d = d - w0 @ w0.mT
        l11 = _potf2(d)
        out[..., tile[j], tile[j]] = l11
        if j + 1 == nt:
            break
        xb = _inv_lower(l11).to(compute_dtype).to(out.dtype)
        wb = []
        for i in range(j + 1, nt):                  # a panel job a tile row
            w = out[..., tile[i], tile[j]].to(compute_dtype).to(out.dtype) \
                @ xb.mT
            out[..., tile[i], tile[j]] = w          # unrounded, the factor
            wb.append(w.to(compute_dtype))          # the bf16 copy
        for ti in range(j + 1, nt):                 # lower pairs but pair 0
            for tj in range(j + 1, ti + 1):
                if ti == tj == j + 1:
                    continue
                out[..., tile[ti], tile[tj]] -= (
                    wb[ti - j - 1].to(out.dtype)
                    @ wb[tj - j - 1].to(out.dtype).mT)
    return torch.tril(out[..., :h, :h])


def dense_diag_inverses(l: torch.Tensor, block: int) -> torch.Tensor:
    """(…, nt, B, B) inverses of the diagonal tiles of dense lower factors
    (…, h, h), the last one identity-padded when h % B ≠ 0."""
    h = l.shape[-1]
    nt = packing.num_tiles(h, block)
    diag = l.new_zeros((*l.shape[:-2], nt, block, block))
    for k in range(nt):
        lo, hi = k * block, min((k + 1) * block, h)
        diag[..., k, :hi - lo, :hi - lo] = l[..., lo:hi, lo:hi]
    diag[..., nt - 1, :, :] += torch.as_tensor(
        packing._identity_tail(h, block), dtype=l.dtype, device=l.device)
    return packing.invert_diag_tiles(diag).contiguous()


def packed_diag_inverses(vec: torch.Tensor, h: int,
                         block: int) -> torch.Tensor:
    """(…, nt, B, B) inverses of the diagonal tiles of packed factors
    (…, P), the last one identity-padded when h % B ≠ 0, at ``vec``'s
    dtype; one inversion serves the forward and the transposed sweep."""
    tiles = vec.reshape(*vec.shape[:-1], -1, block, block)
    return packing.invert_diag_tiles(
        packing._diag_tiles(tiles, h, block)).contiguous()


def solve_lower_blocked(l: torch.Tensor, g: torch.Tensor, block: int, *,
                        transpose: bool = False,
                        compute_dtype=None) -> torch.Tensor:
    """Blocked ``L w = g`` (or ``Lᵀ w = g``): l (…, h, h), g (…, h, q) →
    (…, h, q).  Per tile row, the row panel over the solved columns times
    the solved segment, then the pre-inverted diagonal tile.  With
    ``compute_dtype`` the panel, the solved segment, the inverse and the
    right-hand side g_i − s are rounded to it before their products
    (``src/repro/kernels/trsm.py:42-51``); the inverses are formed and the
    sums kept at ``l``'s dtype."""
    cd = compute_dtype
    h = l.shape[-1]
    nt = packing.num_tiles(h, block)
    hp = nt * block
    inv_diag = dense_diag_inverses(l, block)
    lp = _identity_padded(l, block)
    gp = torch.nn.functional.pad(g, (0, 0, 0, hp - h))
    w = torch.zeros_like(gp)
    for step in range(nt):
        i = nt - 1 - step if transpose else step
        lo, hi = i * block, (i + 1) * block
        if transpose:
            s = _rounded(lp[..., hi:, lo:hi].mT, cd) @ _rounded(w[..., hi:, :],
                                                                 cd)
            inv = inv_diag[..., i, :, :].mT
        else:
            s = _rounded(lp[..., lo:hi, :lo], cd) @ _rounded(w[..., :lo, :],
                                                             cd)
            inv = inv_diag[..., i, :, :]
        w[..., lo:hi, :] = _rounded(inv, cd) @ _rounded(
            gp[..., lo:hi, :] - s, cd)
    return w[..., :h, :]


def solve_lower_blocked_stored(l: torch.Tensor, g: torch.Tensor, block: int,
                               compute_dtype, *,
                               transpose: bool = False) -> torch.Tensor:
    """:func:`solve_lower_blocked` with ``compute_dtype`` products in the
    dataflow of the mixed cluster solve (``csrc/tri_solve.cuh``
    ``tri_solve_mixed_kernel``): each operand rounded once, where it is
    stored, and kept in ``compute_dtype`` — the factor as each staged chunk
    of it becomes a bf16 tile, the inverses of the diagonal tiles (formed
    at ``l``'s dtype) as the prologue stores them — then the same products
    in the same order.  A value rounded once where it is stored is the
    operand that rounding it wherever it is read gives, so this is
    :func:`solve_lower_blocked` (``compute_dtype``) value for value."""
    cd, dt = compute_dtype, l.dtype
    h = l.shape[-1]
    nt = packing.num_tiles(h, block)
    hp = nt * block
    xs = dense_diag_inverses(l, block).to(cd)       # the stored inverses
    lb = _identity_padded(l, block).to(cd)          # the stored tiles
    gp = torch.nn.functional.pad(g, (0, 0, 0, hp - h))
    w = torch.zeros_like(gp)
    for step in range(nt):
        i = nt - 1 - step if transpose else step
        lo, hi = i * block, (i + 1) * block
        if transpose:
            s = lb[..., hi:, lo:hi].mT.to(dt) @ _rounded(w[..., hi:, :], cd)
            x = xs[..., i, :, :].mT
        else:
            s = lb[..., lo:hi, :lo].to(dt) @ _rounded(w[..., :lo, :], cd)
            x = xs[..., i, :, :]
        w[..., lo:hi, :] = x.to(dt) @ _rounded(gp[..., lo:hi, :] - s, cd)
    return w[..., :h, :]


def solve_lower_packed(vec: torch.Tensor, g: torch.Tensor, h: int,
                       block: int, *, transpose: bool = False,
                       compute_dtype=None) -> torch.Tensor:
    """The packed trsm: ``L w = g`` (or ``Lᵀ w = g``) from packed factors
    vec (…, P), g (…, h, m) → (…, h, m) at g's dtype (the accumulation
    dtype; ``vec`` is read at it, exactly for a bf16 factor).  Per tile
    row, the solved segments times the row's tiles (for ``Lᵀ``, column i of
    packed L read as row i of Lᵀ), then the pre-inverted diagonal tile,
    inverted at g's dtype from the factor's own values.  With
    ``compute_dtype`` the tiles, the solved segments, the inverses and the
    right-hand sides g_i − acc_i are rounded to it before their products
    (``src/repro/kernels/packed_trsm.py:61-80``, ``:138``)."""
    cd, dt = compute_dtype, g.dtype
    nt = packing.num_tiles(h, block)
    hp = nt * block
    v = vec.to(dt)
    tiles = _rounded(v.reshape(*v.shape[:-1], -1, block, block), cd)
    inv = _rounded(packed_diag_inverses(v, h, block), cd)
    pmap = packing.tile_pos_map(h, block)
    gp = torch.nn.functional.pad(g, (0, 0, 0, hp - h))
    w = torch.zeros_like(gp)
    for i in (range(nt - 1, -1, -1) if transpose else range(nt)):
        lo, hi = i * block, (i + 1) * block
        acc = torch.zeros_like(gp[..., lo:hi, :])
        for t in (range(i + 1, nt) if transpose else range(i)):
            seg = _rounded(w[..., t * block:(t + 1) * block, :], cd)
            if transpose:
                acc = acc + tiles[..., int(pmap[t, i]), :, :].mT @ seg
            else:
                acc = acc + tiles[..., int(pmap[i, t]), :, :] @ seg
        x = inv[..., i, :, :]
        w[..., lo:hi, :] = (x.mT if transpose else x) @ _rounded(
            gp[..., lo:hi, :] - acc, cd)
    return w[..., :h, :]


def solve_packed(vec: torch.Tensor, g: torch.Tensor, h: int, block: int,
                 compute_dtype=None) -> torch.Tensor:
    """L Lᵀ w = g from packed factors: :func:`solve_lower_packed` forward,
    then transposed on its result (the kernel's two sweeps)."""
    w = solve_lower_packed(vec, g, h, block, compute_dtype=compute_dtype)
    return solve_lower_packed(vec, w, h, block, transpose=True,
                              compute_dtype=compute_dtype)


def interp_diag_inverses(theta: torch.Tensor, x: torch.Tensor, h: int,
                         block: int, accum_dtype=None) -> torch.Tensor:
    """Horner-evaluated, identity-padded and inverted diagonal tiles of the
    interpolated factors: theta (n, r+1, P), x (q,) → (n, q, nt, B, B), at
    ``accum_dtype`` (default Θ's dtype): a bf16 Θ is upcast first, as at
    ``src/repro/kernels/poly_interp.py:247-255``."""
    dt = theta.dtype if accum_dtype is None else accum_dtype
    degree = theta.shape[-2] - 1
    nt = packing.num_tiles(h, block)
    starts = torch.as_tensor(packing.column_starts(h, block).astype("int64"),
                             device=theta.device)
    coeff = theta.reshape(theta.shape[0], degree + 1, -1, block, block
                          ).index_select(2, starts).to(dt)  # (n, r+1, nt, B, B)
    xs = x.to(dt)[None, :, None, None, None]
    diag = coeff[:, degree, None].expand(-1, x.shape[0], -1, -1, -1)
    for k in range(degree - 1, -1, -1):
        diag = diag * xs + coeff[:, k, None]
    tail = packing._identity_tail(h, block)
    if tail.any():
        diag = diag.clone()
        diag[:, :, nt - 1] += torch.as_tensor(tail, dtype=diag.dtype,
                                              device=diag.device)
    return packing.invert_diag_tiles(diag).contiguous()


def interp_factors(theta: torch.Tensor, x: torch.Tensor, h: int,
                   block: int) -> torch.Tensor:
    """Dense interpolated factors: theta (…, r+1, P), x (q,) λ − center at
    Θ's dtype → (…, q, h, h) at Θ's dtype.  Horner over the packed rows,
    then :func:`~repro_torch.core.packing.unpack_tril`.  For a bf16 Θ each
    multiply and each add is a bf16 operation of its own, rounded to
    nearest even (torch computes it in fp32 and rounds), as the kernel
    rounds each step."""
    degree = theta.shape[-2] - 1
    xs = x.to(theta.dtype)[:, None]
    acc = theta.new_zeros((*theta.shape[:-2], x.shape[0], theta.shape[-1]))
    for k in range(degree, -1, -1):
        acc = acc * xs + theta[..., k, None, :]
    return packing.unpack_tril(acc, h, block)


def interp_solve(theta: torch.Tensor, x: torch.Tensor, inv_diag: torch.Tensor,
                 g: torch.Tensor, h: int, block: int,
                 compute_dtype=None) -> torch.Tensor:
    """The fused sweep: theta (n, r+1, P), x (q,) λ−center, inv_diag
    (n, q, nt, B, B), g (n, hp, m) shared or (n, q, hp, m) per λ →
    (n, q, hp, m) at g's dtype.  Each off-diagonal tile is Horner-evaluated
    at Θ's dtype as the walk needs it, x cast to it (a bf16 Θ: each step
    rounded to bf16); the forward sweep is followed by the reverse (Lᵀ)
    sweep.  With ``compute_dtype`` the solved segments, the inverses and
    the right-hand sides g_i − acc_i are rounded to it before their
    products (``src/repro/kernels/poly_interp.py:128-150``)."""
    cd = compute_dtype
    n, r1, _ = theta.shape
    degree = r1 - 1
    nt = packing.num_tiles(h, block)
    pmap = packing.tile_pos_map(h, block)
    tiles = theta.reshape(n, r1, -1, block, block)
    xs = x.to(theta.dtype)[None, :, None, None]

    def tile(p):                                   # (n, q, B, B)
        v = tiles[:, degree, p, None]
        for k in range(degree - 1, -1, -1):
            v = v * xs + tiles[:, k, p, None]
        return v.to(g.dtype)

    def seg(v, t):                                 # solved segment t
        return _rounded(v[..., t * block:(t + 1) * block, :], cd)

    q = x.shape[0]
    g = g if g.ndim == 4 else g[:, None].expand(-1, q, -1, -1)
    w = g.new_zeros(g.shape)
    for i in range(nt):
        lo, hi = i * block, (i + 1) * block
        acc = torch.zeros_like(g[..., lo:hi, :])
        for t in range(i):
            acc = acc + tile(int(pmap[i, t])) @ seg(w, t)
        w[..., lo:hi, :] = _rounded(inv_diag[:, :, i], cd) @ _rounded(
            g[..., lo:hi, :] - acc, cd)
    for i in range(nt - 1, -1, -1):
        lo, hi = i * block, (i + 1) * block
        acc = torch.zeros_like(g[..., lo:hi, :])
        for t in range(i + 1, nt):
            acc = acc + tile(int(pmap[t, i])).mT @ seg(w, t)
        w[..., lo:hi, :] = _rounded(inv_diag[:, :, i].mT, cd) @ _rounded(
            w[..., lo:hi, :] - acc, cd)
    return w


def horner_stored(planes: torch.Tensor, x: torch.Tensor,
                  compute_dtype) -> torch.Tensor:
    """Horner of coefficient planes (r+1, …) at ``x`` as the mixed cluster
    solve turns a staged chunk of a bf16 Θ into a bf16 tile: x rounded to
    ``compute_dtype``, then every product and every sum a float32
    operation rounded to it (the kernel's bf16 pairs, whose one rounding
    of the exact result gives the same values).  Returns the values in
    ``compute_dtype``."""
    def rnd(t):
        return t.to(compute_dtype).float()
    xb = rnd(x.float())
    v = planes[-1].float()
    for k in range(planes.shape[0] - 2, -1, -1):
        v = rnd(rnd(v * xb) + planes[k].float())
    return v.to(compute_dtype)


def interp_solve_stored(theta: torch.Tensor, x: torch.Tensor,
                        inv_diag: torch.Tensor, g: torch.Tensor, h: int,
                        block: int, compute_dtype) -> torch.Tensor:
    """:func:`interp_solve` with ``compute_dtype`` products in the dataflow
    of the mixed cluster solve (``tri_solve_mixed_kernel``): every
    off-diagonal tile Horner-evaluated once into ``compute_dtype``
    (:func:`horner_stored`, the order of the kernel's tiles and of the
    Pallas kernel's casts) and kept, the inverses rounded once where they
    are stored, then the same products in the same order as
    :func:`interp_solve`, which it gives value for value: theta (n, r+1,
    P) in ``compute_dtype``, x (q,), inv_diag (n, q, nt, B, B), g (n, hp,
    m) shared or (n, q, hp, m) per λ → (n, q, hp, m) at g's dtype."""
    cd, dt = compute_dtype, g.dtype
    n, r1, _ = theta.shape
    nt = packing.num_tiles(h, block)
    pmap = packing.tile_pos_map(h, block)
    planes = theta.reshape(n, r1, -1, block, block).movedim(1, 0)
    xs = x[None, :, None, None]
    stored = {}                                  # tile -> (n, q, B, B) in cd
    for a in range(nt):
        for b in range(a):
            p = int(pmap[a, b])
            stored[p] = horner_stored(planes[:, :, p, None], xs, cd)
    xinv = inv_diag.to(cd)                       # the stored inverses
    q = x.shape[0]
    g = g if g.ndim == 4 else g[:, None].expand(-1, q, -1, -1)
    w = g.new_zeros(g.shape)

    def seg(t):
        return _rounded(w[..., t * block:(t + 1) * block, :], cd)
    for i in range(nt):
        lo, hi = i * block, (i + 1) * block
        acc = torch.zeros_like(g[..., lo:hi, :])
        for t in range(i):
            acc = acc + stored[int(pmap[i, t])].to(dt) @ seg(t)
        w[..., lo:hi, :] = xinv[:, :, i].to(dt) @ _rounded(
            g[..., lo:hi, :] - acc, cd)
    for i in range(nt - 1, -1, -1):
        lo, hi = i * block, (i + 1) * block
        acc = torch.zeros_like(g[..., lo:hi, :])
        for t in range(i + 1, nt):
            acc = acc + stored[int(pmap[t, i])].to(dt).mT @ seg(t)
        w[..., lo:hi, :] = xinv[:, :, i].to(dt).mT @ _rounded(
            w[..., lo:hi, :] - acc, cd)
    return w


def invert_lower_tile(l: torch.Tensor, nb: int = 16) -> torch.Tensor:
    """The prologue's inversion in ``csrc/tri_solve.cuh``, in its sub-block
    order: lower tiles (…, B, B) (the upper part is not read) → X = L⁻¹.
    Each ``nb`` × ``nb`` diagonal sub-block by forward substitution (one
    warp each in the kernel), then X_ij = −X_ii Σ_{k=j}^{i−1} L_ik X_kj
    block row by block row."""
    b = l.shape[-1]
    if b % nb:
        raise ValueError(f"invert_lower_tile: tile {b} is not a multiple of "
                         f"nb={nb}")
    l = torch.tril(l)
    sub = [slice(p * nb, (p + 1) * nb) for p in range(b // nb)]
    xd = [_inv_lower(l[..., s, s]) for s in sub]
    x = torch.zeros_like(l)
    for i, si in enumerate(sub):
        x[..., si, si] = xd[i]
        for j in range(i):
            t = l[..., si, j * nb:i * nb] @ x[..., j * nb:i * nb, sub[j]]
            x[..., si, sub[j]] = -xd[i] @ t
    return x


CLUSTER_SIZES = (8, 4, 2, 1)


def cluster_plan(nt: int, cluster: int) -> list[list[int]]:
    """The tile rows each block of one system's cluster owns: block b of
    C = ``cluster`` blocks owns rows b, b + C, b + 2C, … < nt.  C is one of
    :data:`CLUSTER_SIZES` and at most ``nt`` (C = 1 for nt = 1), as the C
    entry points choose it."""
    if cluster not in CLUSTER_SIZES or (cluster > nt and cluster > 1):
        raise ValueError(f"cluster_plan: cluster {cluster} for nt={nt}")
    return [list(range(b, nt, cluster)) for b in range(cluster)]


def solve_right_looking(tile, diag, g: torch.Tensor, nt: int, block: int,
                        cluster: int, sweeps: int = 3) -> torch.Tensor:
    """The cluster kernels' substitution order (``csrc/tri_solve.cuh``).

    ``tile(a, b)`` → (…, B, B) tile (a, b) of L, a > b; ``diag(i)`` → the
    identity-padded diagonal tile i (…, B, B); ``g`` (…, nt·B, m).
    ``sweeps``: 1 solves L v = g, 2 Lᵀ v = g, 3 both in turn (L Lᵀ v = g).
    Each block of :func:`cluster_plan` inverts its own diagonal tiles
    (:func:`invert_lower_tile`); the owner of row i solves v_i = X_i (g_i −
    acc_i) (X_iᵀ for the reverse sweep); then every block adds L_ji v_i
    (rows j > i) or L_ijᵀ v_i (rows j < i) to the pending sums of its rows,
    the owner of the next row first, which then solves it before the
    others finish.  The forward and reverse solutions have slots of their
    own.  Returns the last sweep's solution (…, nt·B, m)."""
    owned = cluster_plan(nt, cluster)
    owner = {i: b for b, rows in enumerate(owned) for i in rows}
    inv = {i: invert_lower_tile(diag(i)) for i in range(nt)}
    seg = [slice(i * block, (i + 1) * block) for i in range(nt)]
    acc = torch.zeros_like(g)
    slots = {True: torch.zeros_like(g), False: torch.zeros_like(g)}
    s_begin = 0 if sweeps & 1 else nt
    s_end = 2 * nt if sweeps & 2 else nt

    def row(s):
        return s if s < nt else 2 * nt - 1 - s

    def solve(s):
        i, fwd = row(s), s < nt
        rhs = (slots[True] if not fwd and sweeps & 1 else g)[..., seg[i], :]
        rhs = rhs - acc[..., seg[i], :]
        acc[..., seg[i], :] = 0
        x = inv[i] if fwd else inv[i].mT
        slots[fwd][..., seg[i], :] = x @ rhs

    def jobs(s, b):         # the rows block b updates after the solve of s
        i = row(s)
        if s < nt - 1:
            return [j for j in owned[b] if j > i]
        if s >= nt:
            return [j for j in reversed(owned[b]) if j < i]
        return []

    def update(s, j):
        i, fwd = row(s), s < nt
        lt = tile(j, i) if fwd else tile(i, j).mT
        acc[..., seg[j], :] += lt @ slots[fwd][..., seg[i], :]

    solve(s_begin)
    for s in range(s_begin, s_end):
        if s + 1 == s_end:
            break
        nxt = owner[row(s + 1)]
        todo = jobs(s, nxt)
        if s != nt - 1:                       # the next row first
            assert todo[0] == row(s + 1)
            update(s, todo.pop(0))
        solve(s + 1)
        for j in todo:
            update(s, j)
        for b in range(len(owned)):
            if b != nxt:
                for j in jobs(s, b):
                    update(s, j)
    return slots[sweeps == 1]


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the Mamba plain versions compute in: float32 for float32
    and bf16 activations (as the kernels), float64 for float64 ones (the
    CPU tests hold the backward passes to autograd there)."""
    return torch.promote_types(dtype, torch.float32)


#: time steps between the segment states the forward keeps for the backward
#: (``kScanSteps`` of ``csrc/ssm_scan.cu``, ``kSeg`` of
#: ``csrc/ssm_scan_bwd.cu``)
STATE_EVERY = 8


def _selective_scan(xc, dt, b_mat, c_mat, a, d_skip, h0, states=False):
    f = _acc_dtype(xc.dtype)
    xc, dt, b_mat, c_mat, a, d_skip = (
        t.to(f) for t in (xc, dt, b_mat, c_mat, a, d_skip))
    bsz, s, di = xc.shape
    n = a.shape[-1]
    h = xc.new_zeros(bsz, di, n) if h0 is None else h0.to(f)
    ys, kept = [], []
    for t in range(s):
        if states and t % STATE_EVERY == 0:
            kept.append(h)
        a_bar = torch.exp(dt[:, t, :, None] * a)
        h = a_bar * h + (dt[:, t] * xc[:, t])[..., None] * b_mat[:, t, None, :]
        ys.append((h * c_mat[:, t, None, :]).sum(-1))
    y = torch.stack(ys, 1) if ys else xc.new_zeros(bsz, 0, di)
    if not states:
        return y + d_skip * xc, h
    return (y + d_skip * xc, h, torch.stack(kept, 1) if kept
            else xc.new_zeros(bsz, 0, di, n))


def ssm_scan(xc: torch.Tensor, dt: torch.Tensor, b_mat: torch.Tensor,
             c_mat: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1 selective scan, one time step at a time, in float32.

    xc, dt: (B, S, di); b_mat, c_mat: (B, S, N); a: (di, N), negative;
    d_skip: (di,).  ``h_t = exp(dt_t·a)⊙h_{t-1} + (dt_t·x_t)⊗B_t``,
    ``y_t = h_t·C_t + d_skip⊙x_t``; returns (y (B, S, di), h_S (B, di, N)).
    Holds one (B, di, N) state, never the (B, S, di, N) decay tensor.
    """
    return _selective_scan(xc, dt, b_mat, c_mat, a, d_skip, None)


def mamba_scan(xc: torch.Tensor, dt_lin: torch.Tensor, dt_bias: torch.Tensor,
               b_mat: torch.Tensor, c_mat: torch.Tensor, a: torch.Tensor,
               d_skip: torch.Tensor, z: torch.Tensor,
               h0: torch.Tensor | None = None, *, states: bool = False
               ) -> tuple:
    """The Mamba-1 mixer from the scan to the gate (the JAX package's
    ``blocks.py:360-379`` and ``:391``; with ``h0``, the SSM step of
    ``mamba_decode``, ``:402-426``).

    xc, z: (B, S, di) in the activation dtype; dt_lin: (B, S, di) float32,
    the ``dt_proj`` product before its bias; dt_bias, d_skip: (di,);
    b_mat, c_mat: (B, S, N); a: (di, N), negative; h0: (B, di, N) or
    ``None`` (zero state).  ``dt = softplus(dt_lin + dt_bias)`` and the scan
    in float32 (:func:`ssm_scan`, from ``h0``), ``y`` rounded to xc's dtype,
    times ``silu(z)`` in that dtype.  Returns (y (B, S, di) in xc's dtype,
    h_last (B, di, N) float32), and with ``states`` also the state before
    steps 0, STATE_EVERY, 2·STATE_EVERY, … (B, ceil(S / STATE_EVERY), di,
    N), the segment states :func:`mamba_scan_bwd` takes.
    """
    dt = F.softplus(dt_lin + dt_bias.to(dt_lin.dtype))
    y, *rest = _selective_scan(xc, dt, b_mat, c_mat, a, d_skip, h0, states)
    return (y.to(xc.dtype) * F.silu(z), *rest)


#: time steps between the states the plain backward keeps (its segments)
BWD_SEGMENT = 64


def _silu_grad(ds: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """silu's backward as PyTorch's kernel writes it: in float32 (float64
    for float64), ``ds·σ(z)·(1 + z·(1 − σ(z)))``, rounded to z's dtype."""
    f = _acc_dtype(z.dtype)
    zf = z.to(f)
    sg = torch.reciprocal(1 + torch.exp(-zf))
    return (ds.to(f) * sg * (1 + zf * (1 - sg))).to(z.dtype)


def mamba_scan_bwd(xc: torch.Tensor, dt_lin: torch.Tensor,
                   dt_bias: torch.Tensor, b_mat: torch.Tensor,
                   c_mat: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
                   z: torch.Tensor, dy: torch.Tensor,
                   h0: torch.Tensor | None = None,
                   dh_last: torch.Tensor | None = None,
                   segment: int = BWD_SEGMENT,
                   states: torch.Tensor | None = None) -> tuple:
    """The backward of :func:`mamba_scan`: the gradients of
    (xc, dt_lin, dt_bias, b_mat, c_mat, a, d_skip, z, h0) given ``dy``
    (the gradient of the gated y, in xc's dtype) and ``dh_last`` (of the
    last state, or ``None``).

    The adjoint of the recurrence is the recurrence run in reverse, as the
    JAX package's ``_clr_bwd`` runs it (``src/repro/models/layers.py:
    388-408``): with ``dy' = dy·silu(z)`` (the gate, in xc's dtype as the
    forward rounds it), ``λ_t = C_t·dy'_t + ā_{t+1}·λ_{t+1}``, then
    ``dā_t = λ_t·h_{t-1}``, ``dB_t = Σ_d λ_t·dt_t x_t``,
    ``dC_t = Σ_d dy'_t·h_t``, through ``ā = exp(dt·A)`` to dt and A and
    through softplus to dt_lin and dt_bias.  The float32 states are
    recomputed from ``h0``: one walk forward keeps the state every
    ``segment`` steps (or they are taken from ``states``, the forward's
    state every STATE_EVERY steps, :func:`mamba_scan`; ``segment`` a
    multiple of it), then each segment, last first, is recomputed and
    the adjoint run back through it; nothing of shape (B, S, d_inner, N) is
    formed.  Returns xc's and z's gradients in xc's dtype, dt_lin's in its
    dtype, the others in float32 (float64 for float64 inputs); h0's is
    ``None`` without ``h0``.
    """
    f = _acc_dtype(xc.dtype)
    act = xc.dtype
    bsz, s, di = xc.shape
    n = a.shape[-1]
    xf, bf, cf, af, df = (t.to(f) for t in (xc, b_mat, c_mat, a, d_skip))
    v = dt_lin.to(f) + dt_bias.to(f)
    dt, sig = F.softplus(v), torch.sigmoid(v)
    u = dt * xf

    def step(h, t):
        return (torch.exp(dt[:, t, :, None] * af) * h
                + u[:, t, :, None] * bf[:, t, None, :])

    if states is not None:
        if segment % STATE_EVERY:
            raise ValueError(f"mamba_scan_bwd: segment {segment} is not a "
                             f"multiple of STATE_EVERY={STATE_EVERY}")
        starts = [states[:, t // STATE_EVERY].to(f)
                  for t in range(0, s, segment)]
    else:
        h = xc.new_zeros(bsz, di, n, dtype=f) if h0 is None else h0.to(f)
        starts = []
        for t in range(s):
            if t % segment == 0:
                starts.append(h)
            h = step(h, t)
    lam = (xc.new_zeros(bsz, di, n, dtype=f) if dh_last is None
           else dh_last.to(f).clone())
    dxf = torch.zeros(bsz, s, di, dtype=f, device=xc.device)
    ddt_lin = torch.zeros_like(dxf)
    dz = torch.zeros_like(z)
    db = torch.zeros(bsz, s, n, dtype=f, device=xc.device)
    dc = torch.zeros_like(db)
    da = torch.zeros(di, n, dtype=f, device=xc.device)
    dd = torch.zeros(di, dtype=f, device=xc.device)
    for k in reversed(range(len(starts))):
        t0 = k * segment
        hs = [starts[k]]
        for t in range(t0, min(s, t0 + segment)):
            hs.append(step(hs[-1], t))
        for t in reversed(range(t0, min(s, t0 + segment))):
            h_t, h_prev = hs[t - t0 + 1], hs[t - t0]
            y = (h_t * cf[:, t, None, :]).sum(-1) + df * xf[:, t]
            dy_t, z_t = dy[:, t].to(act), z[:, t]
            dyp = (dy_t * F.silu(z_t)).to(f)             # through the gate
            dz[:, t] = _silu_grad(dy_t * y.to(act), z_t)
            lam = lam + cf[:, t, None, :] * dyp[..., None]
            dc[:, t] = (h_t * dyp[..., None]).sum(1)
            db[:, t] = (lam * u[:, t, :, None]).sum(1)
            du = (lam * bf[:, t, None, :]).sum(-1)
            a_bar = torch.exp(dt[:, t, :, None] * af)
            g = lam * h_prev * a_bar
            da += (g * dt[:, t, :, None]).sum(0)
            ddt = (g * af).sum(-1) + du * xf[:, t]
            dxf[:, t] = du * dt[:, t] + dyp * df
            dd += (dyp * xf[:, t]).sum(0)
            ddt_lin[:, t] = ddt * sig[:, t]
            lam = a_bar * lam
    return (dxf.to(act), ddt_lin.to(dt_lin.dtype), ddt_lin.sum((0, 1)), db,
            dc, da, dd, dz, None if h0 is None else lam)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal convolution.  x: (B, S, C); w: (C, K); state: the
    last K-1 inputs (B, K-1, C), zeros when ``None``.  Returns (y, the new
    state).

    Written as K shifted multiply-adds in float32, rounded once to
    ``x.dtype``: ``y_t = Σ_k xp_{t+k} w_k`` over ``xp = [state, x]``, the
    cross-correlation ``lax.conv_general_dilated`` computes
    (``src/repro/models/layers.py:300-315``); float64 for float64 x.  No
    cuDNN call, so no TF32 on the card.
    """
    k = w.shape[-1]
    bsz, s, c = x.shape
    if state is None:
        state = x.new_zeros(bsz, k - 1, c)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    xf, wf = xp.to(_acc_dtype(x.dtype)), w.to(_acc_dtype(x.dtype))
    y = xf[:, :s] * wf[:, 0]
    for j in range(1, k):
        y += xf[:, j:j + s] * wf[:, j]
    # a copy: a view would keep the whole (B, S+K-1, C) input alive
    return y.to(x.dtype), xp[:, s:].clone()


def causal_conv1d_silu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       state: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`causal_conv1d` of x with ``w`` in x's dtype, then ``+ b`` and
    ``silu`` in x's dtype (the JAX package's ``blocks.py:387-388``).
    Returns (xc, the new state)."""
    y, new_state = causal_conv1d(x, w.to(x.dtype), state)
    return F.silu(y + b.to(x.dtype)), new_state


def causal_conv1d_silu_bwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           dout: torch.Tensor,
                           state: torch.Tensor | None = None) -> tuple:
    """The backward of :func:`causal_conv1d_silu` given ``dout``, the
    gradient of xc: (dx, dw, db, dstate).

    The pre-activation ``round(round(conv) + b)`` is recomputed as the
    forward computes it; silu's gradient is taken as PyTorch's kernel takes
    it (:func:`_silu_grad`, rounded to x's dtype).  Then, in float32
    (float64 for float64 x), ``dxp_r = Σ_k dpre_{r-k}·w_k`` over the padded
    input ``xp = [state, x]``, summed k = 0 .. K-1 as the plain forward sums
    its taps and rounded once to x's dtype (dx its last S rows, dstate its
    first K-1, ``None`` without a state), ``dw_k = Σ_{b,t} dpre_t·xp_{t+k}``
    and ``db = Σ_{b,t} dpre_t`` in float32.  The new state's gradient is not
    taken (the state is a copy of inputs that training discards).
    """
    k = w.shape[-1]
    act, f = x.dtype, _acc_dtype(x.dtype)
    bsz, s, c = x.shape
    st = x.new_zeros(bsz, k - 1, c) if state is None else state.to(act)
    xp = torch.cat([st, x], dim=1)
    xf, wf = xp.to(f), w.to(act).to(f)
    acc = xf[:, :s] * wf[:, 0]
    for j in range(1, k):
        acc += xf[:, j:j + s] * wf[:, j]
    pre = acc.to(act) + b.to(act)
    dpre = _silu_grad(dout.to(act), pre).to(f)
    dxp = torch.zeros(bsz, s + k - 1, c, dtype=f, device=x.device)
    for j in range(k):
        dxp[:, j:j + s] += dpre * wf[:, j]
    dw = torch.stack([(dpre * xf[:, j:j + s]).sum((0, 1)) for j in range(k)],
                     -1)
    return (dxp[:, k - 1:].to(act), dw, dpre.sum((0, 1)),
            None if state is None else dxp[:, :k - 1].to(act))
