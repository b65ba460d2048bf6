"""The custom pairwise NN's descriptor module and kernel twins against the
JAX package (CPU, float64).

Inputs are numpy arrays from a seed: neighbor slots of a few atoms with
masked slots in the middle of a row, an atom with no live slot, pairs on
the 3.5-5.0 ramp of the radial cutoff, pairs at r >= the 5.0 cutoff (the
neighbor lists reach the reference potential's cutoff), pairs at exactly
r = 3.5 and r = c (where `jnp.where` takes the derivative of the branch it
selects), and a one-slot case.  Widths: the JAX defaults (8 radial, 23
3-body) and a narrow 4 / 6.  Checks, each to 1e-12 relative to the
largest magnitude:

- `cutoff_function`, `cutoff_function_3body`, `bessel_basis`, `g3b_basis`
  and `pair_descriptors` against the JAX functions;
- the closed forms `pair_desc_vjp` against `jax.vjp` and `pair_desc_jvp`
  against `jax.jvp` of the descriptors and the envelope, and each against
  `torch.autograd` / `torch.func.jvp` of the plain forward;
- the pair gradient of the JAX pairwise energy closure (MLP on the
  standardized descriptors, times the envelope) against the MLP's dE/dx
  and the pair energies taken through `pair_desc_vjp`;
- `PairDescForce`'s MLP-parameter gradient of a force-and-energy loss
  against plain double autograd through the plain descriptors;
- the wrappers take their plain versions for CPU tensors without counting
  a launch, and refuse a `meta` tensor;
- the Gaussian recurrence of K15V and K15T (`csrc/pair_desc.cu`'s note),
  evaluated in numpy, against exp(-eta (x - mu)^2) with the JAX
  package's centres and against its derivative, to the note's 4e-14
  relative, for M = 1, 2, 6, 23 and 64 over x in [-2, 2].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fitsnap_tpu.models.mlp import atom_energies as jax_atom_energies
from fitsnap_tpu.ops import custom_desc as jdesc
from fitsnap_tpu_torch.kernels import custom_kernels as ck
from fitsnap_tpu_torch.kernels import nn_kernels as nk
from fitsnap_tpu_torch.models.mlp import atom_energies
from fitsnap_tpu_torch.ops import custom_desc as tdesc

TOL = 1e-12
RECUR_TOL = 4e-14          # the recurrence's bound (csrc/pair_desc.cu)
CUTOFF = 5.0
WIDTHS = {"full": (8, 23), "narrow": (4, 6), "k1": (8, 23)}


def rel(port, ref):
    port = np.asarray(port.detach() if torch.is_tensor(port) else port,
                      np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


def case(name):
    """(disp (A, K, 3), mask (A, K), R, M) of one case."""
    rng = np.random.default_rng({"full": 3, "narrow": 3, "k1": 4}[name])
    R, M = WIDTHS[name]
    if name == "k1":
        disp = rng.normal(size=(3, 1, 3)) * 2.0
        mask = np.array([[True], [True], [False]])
        return disp, mask, R, M
    A, K = 6, 12
    u = rng.normal(size=(A, K, 3))
    disp = u / np.linalg.norm(u, axis=-1, keepdims=True) \
        * rng.uniform(1.8, 5.8, (A, K, 1))
    disp[0, 0] = [3.5, 0.0, 0.0]          # the ramp's start, exactly
    disp[0, 1] = [0.0, CUTOFF, 0.0]       # the cutoff, exactly
    disp[0, 2] = [4.2, 0.5, -0.3]         # on the ramp
    disp[0, 3] = [5.6, 0.2, 0.0]          # past the cutoff
    mask = rng.random((A, K)) < 0.8
    mask[0, :4] = True
    mask[1, 5] = mask[2, 0] = False       # dead slots mid-row
    mask[5] = False                       # an atom with no live slot
    return disp, mask, R, M


def jax_closure(mask, R, M):
    """disp -> (pair descriptors, envelope fc * mask), the JAX functions."""
    m = jnp.asarray(mask)

    def f(d):
        desc = jdesc.pair_descriptors(d, m, CUTOFF, R, M)
        safe = jnp.where(m[..., None], d,
                         jnp.array([2.0 * jdesc.RMIN_CUT, 0.0, 0.0]))
        fc = jdesc.cutoff_function(jnp.sqrt(jnp.sum(safe * safe, -1)),
                                   CUTOFF)
        return desc, fc * m
    return f


def torch_forward(mask, R, M):
    m = torch.as_tensor(mask)
    return lambda d: (tdesc.pair_descriptors(d, m, CUTOFF, R, M),
                      tdesc.envelope(d, m, CUTOFF))


def cotangents(name, disp, R, M):
    rng = np.random.default_rng(50 + len(name))
    A, K, _ = disp.shape
    return (rng.normal(size=(A, K, R + M)), rng.normal(size=(A, K)),
            rng.normal(size=(A, K, 3)))


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_basis_functions_equal_jax(name):
    disp, mask, R, M = case(name)
    r = np.concatenate([np.linspace(0.5, 6.0, 57), [3.5, CUTOFF, 5.2]])
    for jf, tf in ((jdesc.cutoff_function, tdesc.cutoff_function),
                   (jdesc.cutoff_function_3body,
                    tdesc.cutoff_function_3body)):
        assert rel(tf(torch.as_tensor(r), CUTOFF),
                   jf(jnp.asarray(r), CUTOFF)) <= TOL
    fc = np.array(jdesc.cutoff_function(jnp.asarray(r), CUTOFF))
    assert rel(tdesc.bessel_basis(torch.as_tensor(r), torch.as_tensor(fc),
                                  CUTOFF, R),
               jdesc.bessel_basis(jnp.asarray(r), jnp.asarray(fc), CUTOFF,
                                  R)) <= TOL
    rr = np.linalg.norm(disp, axis=-1)
    unit, fc3 = disp / rr[..., None], np.cos(rr) ** 2
    assert rel(tdesc.g3b_basis(torch.as_tensor(unit), torch.as_tensor(fc3),
                               torch.as_tensor(mask, dtype=torch.float64),
                               M),
               jdesc.g3b_basis(jnp.asarray(unit), jnp.asarray(fc3),
                               jnp.asarray(mask, jnp.float64), M)) <= TOL


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_pair_descriptors_equal_jax(name):
    disp, mask, R, M = case(name)
    desc, fc = torch_forward(mask, R, M)(torch.as_tensor(disp))
    jd, jfc = jax_closure(mask, R, M)(jnp.asarray(disp))
    assert desc.shape == (*mask.shape, R + M)
    assert rel(desc, jd) <= TOL and rel(fc, jfc) <= TOL
    assert (desc[torch.as_tensor(~mask)] == 0).all()
    # the plain version of K15 is the same pair
    out = ck.pair_desc(torch.as_tensor(disp), torch.as_tensor(mask), CUTOFF,
                       R, M)
    assert torch.equal(out[0], desc) and torch.equal(out[1], fc)


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_vjp_equals_jax_vjp(name):
    disp, mask, R, M = case(name)
    gd, ee, _ = cotangents(name, disp, R, M)
    _, vjp = jax.vjp(jax_closure(mask, R, M), jnp.asarray(disp))
    ref, = vjp((jnp.asarray(gd), jnp.asarray(ee)))
    out = tdesc.pair_desc_vjp(torch.as_tensor(gd), torch.as_tensor(ee),
                              torch.as_tensor(disp), torch.as_tensor(mask),
                              CUTOFF, R, M)
    assert rel(out, ref) <= TOL
    assert (out[torch.as_tensor(~mask)] == 0).all()


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_jvp_equals_jax_jvp(name):
    disp, mask, R, M = case(name)
    _, _, h = cotangents(name, disp, R, M)
    _, (jd, jfc) = jax.jvp(jax_closure(mask, R, M), (jnp.asarray(disp),),
                           (jnp.asarray(h),))
    out, fcdot = tdesc.pair_desc_jvp(torch.as_tensor(h),
                                     torch.as_tensor(disp),
                                     torch.as_tensor(mask), CUTOFF, R, M)
    assert rel(out, jd) <= TOL and rel(fcdot, jfc) <= TOL


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_closed_forms_equal_torch_autograd(name):
    """The second oracle: autograd of the plain forward."""
    disp, mask, R, M = case(name)
    gd, ee, h = (torch.as_tensor(x) for x in cotangents(name, disp, R, M))
    f = torch_forward(mask, R, M)
    d = torch.as_tensor(disp).requires_grad_(True)
    desc, fc = f(d)
    ref, = torch.autograd.grad((desc * gd).sum() + (fc * ee).sum(), d)
    m = torch.as_tensor(mask)
    out = tdesc.pair_desc_vjp(gd, ee, torch.as_tensor(disp), m, CUTOFF, R, M)
    assert rel(out, ref) <= TOL
    _, (jd, jfc) = torch.func.jvp(f, (torch.as_tensor(disp),), (h,))
    out, fcdot = tdesc.pair_desc_jvp(h, torch.as_tensor(disp), m, CUTOFF, R,
                                     M)
    assert rel(out, jd) <= TOL and rel(fcdot, jfc) <= TOL


def mlp(D, nelem, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(nelem, a, b)) / np.sqrt(a),
             rng.normal(size=(nelem, b)) * 0.1)
            for a, b in ((D, 7), (7, 5), (5, 1))]


@pytest.mark.parametrize("nelem", [1, 2])
def test_energy_gradient_equals_jax_closure(nelem):
    """jax.value_and_grad of the JAX pairwise energy (JAX
    `_forward_pairwise`'s `config_energy`) against the port's pieces: the
    MLP's dE/dx and the pair energies through `pair_desc_vjp`."""
    disp, mask, R, M = case("full")
    D = R + M
    A, K = mask.shape
    rng = np.random.default_rng(60)
    mean, std = rng.normal(size=D) * 0.1, rng.uniform(0.5, 1.5, D)
    params = mlp(D, nelem, 61)
    types = rng.integers(0, nelem, A).astype(np.int32)
    el = types[:, None] * np.ones((A, K), np.int32)
    f = jax_closure(mask, R, M)

    def config_energy(d):
        desc, fc = f(d)
        e_pair = jax_atom_energies(
            [(jnp.asarray(w), jnp.asarray(b)) for w, b in params],
            (desc - mean) / std, jnp.asarray(el))
        return jnp.sum(e_pair * fc)

    e_ref, g_ref = jax.value_and_grad(config_energy)(jnp.asarray(disp))
    tparams = [(torch.as_tensor(w), torch.as_tensor(b)) for w, b in params]
    td, tm = torch.as_tensor(disp), torch.as_tensor(mask)
    desc, fc = ck.pair_desc(td, tm, CUTOFF, R, M)
    x = ((desc - torch.as_tensor(mean)) / torch.as_tensor(std)) \
        .reshape(-1, D).requires_grad_(True)
    e_pair = atom_energies(tparams, x, torch.as_tensor(el).reshape(-1)) \
        .reshape(A, K)
    e = (e_pair * fc).sum()
    dedx, = torch.autograd.grad(e, x)
    g = ck.pair_desc_vjp((dedx / torch.as_tensor(std)).reshape(A, K, D),
                         e_pair.detach() * tm, td, tm, CUTOFF, R, M)
    assert abs(e.item() - float(e_ref)) <= TOL * abs(float(e_ref))
    assert rel(g, g_ref) <= TOL


def test_pair_desc_force_gradient_equals_double_autograd():
    """The MLP-parameter gradient of a force-and-energy loss through
    PairDescForce (the plain K15V and gather; backward the plain K15T)
    against plain double autograd through the plain descriptors."""
    rng = np.random.default_rng(70)
    N, A, K = 2, 4, 6
    disp = np.zeros((N, A, K, 3))
    mask = np.zeros((N, A, K), bool)
    jidx = np.zeros((N, A, K), np.int32)
    for n in range(N):
        # a periodic pair list: slots of atom a list the other atoms
        for a in range(A - n):
            js = [j for j in range(A - n) if j != a]
            for k, j in enumerate(js):
                d = rng.normal(size=3)
                disp[n, a, k] = d / np.linalg.norm(d) * rng.uniform(2, 5.4)
                mask[n, a, k] = True
                jidx[n, a, k] = j
    from fitsnap_tpu_torch.ops.neighbors import reverse_neighbors
    rows = [reverse_neighbors(jidx[n], mask[n], A) for n in range(N)]
    rev = np.full((N, A, max(r.shape[1] for r in rows)), -1, np.int32)
    for n, r in enumerate(rows):
        rev[n, :, :r.shape[1]] = r
    R, M = 8, 23
    D = R + M
    params = [(torch.as_tensor(w).requires_grad_(True),
               torch.as_tensor(b).requires_grad_(True))
              for w, b in mlp(D, 1, 71)]
    leaves = [t for wb in params for t in wb]
    mean = torch.as_tensor(rng.normal(size=D) * 0.1)
    std = torch.as_tensor(rng.uniform(0.5, 1.5, D))
    target = torch.as_tensor(rng.normal(size=(N, A, 3)))
    td, tm, tj, tr = (torch.as_tensor(x) for x in (disp, mask, jidx, rev))
    elem = torch.zeros(N * A * K, dtype=torch.int32)

    def loss(e, forces):
        return ((forces - target) ** 2).sum() + e ** 2

    desc, fc = ck.pair_desc(td, tm, CUTOFF, R, M)
    x = ((desc - mean) / std).reshape(-1, D).requires_grad_(True)
    e_pair = atom_energies(params, x, elem).reshape(N, A, K)
    e = (e_pair * fc).sum()
    dedx, = torch.autograd.grad(e, x, create_graph=True)
    forces = ck.PairDescForce.apply((dedx / std).reshape(N, A, K, D),
                                    e_pair * tm, td, tm, tj, tr, CUTOFF, R,
                                    M)
    out = torch.autograd.grad(loss(e, forces), leaves)

    d = td.clone().requires_grad_(True)
    x = ((tdesc.pair_descriptors(d, tm, CUTOFF, R, M) - mean) / std) \
        .reshape(-1, D)
    e = (atom_energies(params, x, elem).reshape(N, A, K)
         * tdesc.envelope(d, tm, CUTOFF)).sum()
    g, = torch.autograd.grad(e, d, create_graph=True)
    ref = torch.autograd.grad(loss(e, nk.nn_pair_gather_plain(g, tr)),
                              leaves)
    for o, r in zip(out, ref):
        assert rel(o, r) <= TOL


def _kernel_calls(device):
    disp, mask, R, M = case("narrow")
    gd, ee, h = cotangents("narrow", disp, R, M)
    A, K = mask.shape
    jidx = np.random.default_rng(80).integers(0, A, (1, A, K)) \
        .astype(np.int32)
    gF = np.random.default_rng(81).normal(size=(1, A, 3))

    def t(x):
        return torch.as_tensor(x, device=device)

    d, m = t(disp), t(mask)
    return {
        "pair_desc": lambda: ck.pair_desc(d, m, CUTOFF, R, M),
        "pair_desc_vjp": lambda: (ck.pair_desc_vjp(t(gd), t(ee), d, m,
                                                   CUTOFF, R, M),),
        "pair_desc_jvp": lambda: ck.pair_desc_jvp(t(h), d, m, CUTOFF, R, M)
        + ck.pair_desc_jvp(t(gF), d[None], m[None], CUTOFF, R, M,
                           jidx=t(jidx)),
    }


@pytest.mark.parametrize("name", ["pair_desc", "pair_desc_vjp",
                                  "pair_desc_jvp"])
def test_wrappers_plain_on_cpu_and_raise_on_meta(name):
    """K15, K15V and K15T run their plain version for CPU tensors without
    counting a launch, and refuse a `meta` tensor."""
    ck.reset_launches()
    out = _kernel_calls("cpu")[name]()
    assert all(torch.isfinite(x).all() for x in out)
    assert ck.launches() == dict.fromkeys(
        ["pair_desc", "pair_desc_vjp", "pair_desc_jvp"], 0)
    with pytest.raises(ValueError, match="no kernel for device"):
        _kernel_calls("meta")[name]()


def recurrence_gaussians(x, mu):
    """G_m(x) and G'_m(x) (len(x), M) by K15V's and K15T's chunk recurrence,
    step for step as `csrc/pair_desc.cu` states it: chunks of 8 columns
    (one column for M <= 2), each anchored by G = exp(-eta x0^2) and rho =
    exp(a x0 - b) at x0 = x - mu[m0], then G *= rho, rho *= q, with delta =
    2 / (M - 1), a = 2 eta delta, b = eta delta^2, q = exp(-2 b), and G' =
    -2 eta (x - mu_m) G."""
    M = len(mu)
    mc = 1 if M <= 2 else 8
    d = 2.0 / (M - 1) if M > 2 else 0.0
    a, b = 2.0 * tdesc.ETA * d, tdesc.ETA * d * d
    q = np.exp(-2.0 * b)
    G, Gp = np.empty((len(x), M)), np.empty((len(x), M))
    for m0 in range(0, M, mc):
        x0 = x - mu[m0]
        g, rho = np.exp(-tdesc.ETA * (x0 * x0)), np.exp(a * x0 - b)
        for m in range(m0, min(m0 + mc, M)):
            G[:, m] = g
            Gp[:, m] = -2.0 * tdesc.ETA * (x - mu[m]) * g
            g, rho = g * rho, rho * q
    return G, Gp


@pytest.mark.parametrize("M", [1, 2, 6, 23, 64])
def test_gaussian_recurrence_equals_exp(M):
    """The kernels' Gaussians by recurrence against the JAX package's
    exp(-eta (x - mu)^2) (`g3b_basis`, mu = jnp.linspace(-1, 1, M)) and
    its derivative in x, element by element, to RECUR_TOL relative, for
    x over [-2, 2] (the cosines' [-1, 1] and beyond)."""
    x = np.concatenate([np.linspace(-2.0, 2.0, 40001), [0.0, -1.0, 1.0]])
    mu = np.asarray(jnp.linspace(-1.0, 1.0, M).astype(jnp.float64))
    G, Gp = recurrence_gaussians(x, mu)
    diff = jnp.asarray(x)[:, None] - jnp.asarray(mu)
    gauss = jnp.exp(-jdesc.ETA * diff ** 2)
    ref = np.asarray(gauss)
    dref = np.asarray(-2.0 * jdesc.ETA * diff * gauss)
    assert ref.min() > 0.0
    assert np.max(np.abs(G - ref) / ref) <= RECUR_TOL
    live = dref != 0.0
    assert np.max(np.abs(Gp - dref)[live] / np.abs(dref[live])) <= RECUR_TOL
    assert (Gp[~live] == 0.0).all()
