"""Custom pairwise descriptors: Bessel radial + Gaussian 3-body (PyTorch).

Counterpart of `fitsnap_tpu/ops/custom_desc.py` (the reference's
`lib/neural_networks/descriptors/bessel.py` and `g3b.py`, which use
different cutoff functions):

  g_n(r)  = sqrt(2/c) sin(n pi r / c)/r * fc(r),          n = 1..num_radial
  fc(r)   = 1 (r <= 3.5) else 0.5 + 0.5 cos(pi (r-3.5)/(c-3.5)), 0 at r >= c
  d_m(ij) = sum_k exp(-eta (cos_jk - mu_m)^2) fc3(r_ik),
  fc3(r)  = 0.5 + 0.5 cos(pi r / c), 0 at r >= c,
  cos_jk  = u_ij . u_ik, zeroed at k == j (the diagonal term is kept with
            its cosine zeroed, as the reference's fill_diagonal_),
  mu = linspace(-1, 1, num_3body), eta = 4.

The plain versions of kernel K15 and of its two derivatives live here:
`pair_descriptors` (the JAX function, bug for bug) with `envelope` (the
pair energy's cutoff fc of JAX `solvers/network.py:700-703`), and the
closed forms `pair_desc_vjp` and `pair_desc_jvp`, written out rather than
taken by autograd: they are the oracles of K15V and K15T.  Each `where`
takes the derivative of the branch it selects, as `jnp.where` does: a
masked slot (the `safe` placeholder), a pair at r >= c and the constant
branch r <= 3.5 of fc carry no radial derivative.
"""

import math

import torch

RMIN_CUT = 3.5
ETA = 4.0


def cutoff_function(r, c):
    """The radial leg's cutoff (reference bessel.py:76-87, rmin 3.5), with
    pairs at r >= c clamped to 0."""
    ramp = 0.5 + 0.5 * torch.cos(math.pi * (r - RMIN_CUT) / (c - RMIN_CUT))
    return torch.where(r >= c, torch.zeros_like(r),
                       torch.where(r > RMIN_CUT, ramp, torch.ones_like(r)))


def cutoff_function_3body(r, c):
    """The 3-body leg's cutoff (reference g3b.py:105: rmin 0 cosine)."""
    return torch.where(r >= c, torch.zeros_like(r),
                       0.5 + 0.5 * torch.cos(math.pi * r / c))


def _cutoff_derivative(r, c):
    """d fc / dr of `cutoff_function`, branch by branch."""
    w = math.pi / (c - RMIN_CUT)
    ramp = -0.5 * w * torch.sin(w * (r - RMIN_CUT))
    zero = torch.zeros_like(r)
    return torch.where(r >= c, zero, torch.where(r > RMIN_CUT, ramp, zero))


def _cutoff_3body_derivative(r, c):
    return torch.where(r >= c, torch.zeros_like(r),
                       -0.5 * (math.pi / c) * torch.sin(math.pi * r / c))


def gauss_centres(num_3body, dtype, device):
    """The Gaussians' centres mu = linspace(-1, 1, num_3body)."""
    return torch.linspace(-1.0, 1.0, num_3body, dtype=dtype, device=device)


def bessel_basis(r, fc, c, num_radial):
    """(..., num_radial) radial Bessel functions."""
    n = torch.arange(1, num_radial + 1, dtype=r.dtype, device=r.device)
    rb = math.sqrt(2.0 / c) * torch.sin((n * math.pi / c) * r[..., None]) \
        / r[..., None]
    return rb * fc[..., None]


def g3b_basis(diff_unit, fc, mask, num_3body):
    """Gaussian 3-body descriptors per pair.

    diff_unit: (A, K, 3) unit displacements; fc: (A, K) cutoffs of the k
    legs; mask: (A, K).  For pair (i, j): the sum over k of
    exp(-eta (cos_jk - mu)^2) fc_ik, with cos_jj zeroed."""
    dtype = diff_unit.dtype
    mu = gauss_centres(num_3body, dtype, diff_unit.device)
    cosjk = torch.einsum("...kc,...lc->...kl", diff_unit, diff_unit)
    K = diff_unit.shape[-2]
    eye = torch.eye(K, dtype=dtype, device=diff_unit.device)
    cosjk = cosjk * (1.0 - eye)
    gauss = torch.exp(-ETA * (cosjk[..., None] - mu) ** 2)    # (.., K, K, M)
    wk = (fc * mask)[..., None, :, None]                      # over k axis
    return (gauss * wk).sum(dim=-2)                           # (.., K, M)


def _geometry(disp, mask):
    """(safe displacement, r, unit vector, mask as float) of every slot;
    masked slots hold the placeholder (2 * 3.5, 0, 0)."""
    mask = mask.to(torch.bool)
    place = torch.tensor([2.0 * RMIN_CUT, 0.0, 0.0], dtype=disp.dtype,
                         device=disp.device)
    safe = torch.where(mask[..., None], disp, place)
    r = torch.sqrt(torch.sum(safe * safe, -1))
    return safe, r, safe / r[..., None], mask.to(disp.dtype)


def pair_descriptors(disp, mask, cutoff, num_radial, num_3body):
    """Concatenated per-pair descriptors (A, K, num_radial + num_3body)."""
    _, r, unit, m = _geometry(disp, mask)
    fc = cutoff_function(r, cutoff) * m
    rbf = bessel_basis(r, fc, cutoff, num_radial)
    g3 = g3b_basis(unit, cutoff_function_3body(r, cutoff), m, num_3body)
    return torch.cat([rbf, g3], dim=-1) * m[..., None]


def envelope(disp, mask, cutoff):
    """(A, K) radial cutoff fc of each live pair, 0 on masked slots: the
    envelope of the pairwise model's pair energies."""
    _, r, _, m = _geometry(disp, mask)
    return cutoff_function(r, cutoff) * m


def _parts(disp, mask, cutoff, num_radial, num_3body):
    """Per-slot values the two derivatives share: r, u, mask, the radial
    term's d/dr (A, K, R), fc' (A, K), fc3 and fc3' (masked), the cosines
    (A, K, K) with the diagonal zeroed, the Gaussians G and their cosine
    derivatives G' (A, K, K, M)."""
    _, r, u, m = _geometry(disp, mask)
    c = cutoff
    fc = cutoff_function(r, c) * m
    dfc = _cutoff_derivative(r, c) * m
    n = torch.arange(1, num_radial + 1, dtype=r.dtype, device=r.device)
    b = n * math.pi / c
    amp = math.sqrt(2.0 / c)
    br = b * r[..., None]
    s = amp * torch.sin(br) / r[..., None]
    ds = amp * (b * torch.cos(br) - torch.sin(br) / r[..., None]) \
        / r[..., None]
    drad = ds * fc[..., None] + s * dfc[..., None]
    fc3 = cutoff_function_3body(r, c) * m
    dfc3 = _cutoff_3body_derivative(r, c) * m
    K = r.shape[-1]
    off = 1.0 - torch.eye(K, dtype=r.dtype, device=r.device)
    cos = torch.einsum("...jc,...kc->...jk", u, u) * off
    mu = gauss_centres(num_3body, r.dtype, r.device)
    x = cos[..., None] - mu
    G = torch.exp(-ETA * x * x)
    Gp = -2.0 * ETA * x * G
    return r, u, m, drad, dfc, fc3, dfc3, cos, off, G, Gp


def pair_desc_vjp(g_desc, e_env, disp, mask, cutoff, num_radial, num_3body):
    """(A, K, 3) pair gradient g = J^T g_desc + e_env * grad fc, J the
    jacobian of `pair_descriptors` with respect to `disp` and fc its
    `envelope`: what `jax.value_and_grad` of the JAX pairwise energy
    yields once the MLP's dE/d(descriptor) is known.

    Per slot s, with P[j, k] = fc3_k sum_m gm[j, m] G'_m(cos_jk) (k != j):
      g_s = u_s (sum_n gr[s, n] d(g_n fc)/dr + e_env_s fc'_s
                 + fc3'_s sum_j sum_m gm[j, m] G_m(cos_js))
            + sum_o (P[s, o] + P[o, s]) (u_o - cos_so u_s) / r_s,
    where gr and gm are g_desc's radial and 3-body columns: the cosine of
    the pair (s, o) reaches both of its legs."""
    r, u, m, drad, dfc, fc3, dfc3, cos, off, G, Gp = _parts(
        disp, mask, cutoff, num_radial, num_3body)
    gd = g_desc * m[..., None]
    gr, gm = gd[..., :num_radial], gd[..., num_radial:]
    radial = (gr * drad).sum(-1) + e_env * dfc
    Q = torch.einsum("...jm,...jkm->...k", gm, G)
    P = torch.einsum("...jm,...jkm->...jk", gm, Gp) * fc3[..., None, :] * off
    W = P + P.transpose(-1, -2)
    # sum_o W[s, o] (u_o - cos_so u_s)
    ang = torch.einsum("...so,...oc->...sc", W, u) \
        - (W * cos).sum(-1)[..., None] * u
    g = u * (radial + Q * dfc3)[..., None] + ang / r[..., None]
    return g * m[..., None]


def pair_desc_jvp(h, disp, mask, cutoff, num_radial, num_3body):
    """The transpose of `pair_desc_vjp` with respect to (g_desc, e_env):
    (J h (A, K, num_radial + num_3body), grad fc . h (A, K)) for a tangent
    h (A, K, 3) of the displacements."""
    r, u, m, drad, dfc, fc3, dfc3, cos, off, G, Gp = _parts(
        disp, mask, cutoff, num_radial, num_3body)
    h = h * m[..., None]
    a = (u * h).sum(-1)                       # radial tangent of each slot
    hu = torch.einsum("...jc,...kc->...jk", h, u)      # h_j . u_k
    dcos = ((hu - cos * a[..., :, None]) / r[..., :, None]
            + (hu.transpose(-1, -2) - cos * a[..., None, :])
            / r[..., None, :]) * off
    g3 = torch.einsum("...jkm,...jk->...jm", Gp, dcos * fc3[..., None, :]) \
        + torch.einsum("...jkm,...k->...jm", G, dfc3 * a)
    radial = drad * a[..., None]
    out = torch.cat([radial, g3], dim=-1) * m[..., None]
    return out, dfc * a * m
