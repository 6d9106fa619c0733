"""Forward-mode Heston QE reconstruction: the CUDA kernel and its plain version.

Replaces no TPU kernel.  On the TPU the differentiated Heston route rebuilds
the path on the path kernel's emitted draws (``montecarlo_risk_engine_tpu/
ops/pallas_paths_ad.py`` ``_reconstruct``) under ``jit``, and XLA fuses the
rebuild and its tangents.  The port runs eagerly: under ``vmap(jvp)`` each
of the ~70 ops of ``HestonModel.step_qe`` becomes a primal and a tangent
kernel over [c, N] float64, some 14,000 launches a run of the Heston
greeks, whose host dispatch kept the card idle (PERF.md section 5).  This
kernel runs the whole rebuild in one launch, or its tangents for one sweep
of c directions in another.

What it computes: the coarse plane [T, N, 2] of ``ops/paths_ad.
emitted_noise_fns``' ``recon_fn`` (``_reconstruct`` running ``step_qe``
with the fuzzy branches on the frozen float32 draws z [T', N, 2], u [T', N]
of the substep-dense timeline) or, given c tangents of its inputs, its c
tangent planes [c, T, N, 2].  Per dense step with length, ``step_qe`` op
for op in torch's association order (the CIR moments, psi, the quadratic
branch, the exponential mixture with its width-0.3 mass ramp, the width-0.5
psi switch, ``var_int``, ``vol``, ``log_s_next``, every ``_EPS`` guard and
clamp as written), each tangent by the rule ``torch.func.jvp`` applies to
that op (torchgen's ``derivatives.yaml``):

  * x * y: y' x + x' y; x / y (result r): (x' - y' r) / y; x +- y: x' +- y';
  * x / k, x * k with a float k: x' / k, x' k; k - x: -x';
  * 1 / x (``Tensor.__rtruediv__``, a reciprocal r times 1.0): -x' (r r);
  * sqrt(x) (result r): x' / (2 r); log(x): x' / x; x ** 2: x' (2 x);
  * clamp(x, lo[, hi]): x' where lo <= x [<= hi] (the ties included), else 0;
  * a value with no tangent (z, u, and so 1 - u) adds no product.

The per-step values that depend on the parameters and dt alone (e^{-kappa
dt}, its complement, the variance's constant term, K0-K4, rate dt) and
theta, sigma and kappa are the columns of a table [T', 12]
(:func:`columns`), computed in torch by one vectorised call over the dense
dt column, with their tangents by ``jvp``; (log S0, v0) is the initial
state.  Under QE the noise transform L is the identity and depends on no
parameter (:func:`model_supported` checks both), so the correlated noise is z.

:func:`qe_planes` dispatches on the device: CPU tensors run
:func:`qe_planes_reference`, the recurrence in plain torch with the tangent
arithmetic written out; CUDA tensors launch ``csrc/qe_tangents.cu`` (one
build per tangent count, at most :data:`MAX_TANGENTS` a launch, counted by
tangent count in ``qe_planes.launches``) or raise.  Under ``vmap(jvp)`` the
route's ``torch.autograd.Function`` gives the primal plane in its forward
and the tangent planes in its ``jvp`` through the custom op
``mcre::qe_tangents``, whose vmap rule hands the sweep's c tangents to one
launch.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import weakref
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from montecarlo_risk_engine_tpu_torch.ops import cuda_build
from montecarlo_risk_engine_tpu_torch.ops.paths_ad import _schedule, dense_timeline

# csrc/qe_tangents.cu: the most tangents a launch carries (more go in
# several launches).
MAX_TANGENTS = 8
# The table's columns, per dense step.
COLUMNS = ("ekt", "one_minus_ekt", "var_const", "k0", "k1", "k2", "k3", "k4", "rate_dt",
           "theta", "sigma", "kappa")
_EPS = 1e-12  # models/heston.py


@functools.lru_cache(maxsize=32)
def plan(calibration_date: float, timeline: Tuple[float, ...], num_steps: int):
    """(steps [T', 2] int32, dts [T'] float64, number of coarse points) on
    a timeline: per dense step whether it has length and the coarse point
    it emits (-1: none), and its dt as ``model.step`` forms it from (t1,
    t2) = (t_prev, t_prev + dt) (0 for a step without length)."""
    dense, orig_idx = dense_timeline(calibration_date, timeline, num_steps)
    emit = np.full(len(dense), -1, dtype=np.int32)
    emit[orig_idx] = np.arange(len(orig_idx))
    live, dts = [], []
    for t_prev, dt in _schedule(calibration_date, dense):
        live.append(int(dt > 0.0))
        dts.append((t_prev + dt) - t_prev if dt > 0.0 else 0.0)
    steps = np.stack([np.asarray(live, dtype=np.int32), emit], axis=1)
    return steps, np.asarray(dts, dtype=np.float64), len(orig_idx)


def columns(model, params, dts: torch.Tensor):
    """(table [T', 12], init [2]) of a Heston model's parameters on the
    dense dts: the :data:`COLUMNS` of each step, as ``step_qe`` forms them
    (``_cir_conditional_moments``' e^{-kappa dt} and constant variance term,
    ``_qe_k_coefficients``, rate dt), and (log S0, v0) of ``init_state``."""
    spot, sigma, rate, _, kappa, theta, v0 = model._unpack(params)
    ekt = torch.exp(-kappa * dts)
    var_const = theta * sigma * sigma * (1.0 - ekt) ** 2 / (2.0 * kappa)
    k0, k1, k2, k3, k4 = model._qe_k_coefficients(params, dts)
    n = dts.shape[0]
    table = torch.stack([ekt, 1.0 - ekt, var_const, k0, k1, k2, k3, k4, rate * dts,
                         theta.expand(n), sigma.expand(n), kappa.expand(n)], dim=-1)
    return table, torch.stack([torch.log(spot), v0])


# -- the plain version ----------------------------------------------------------------


def _qe_step(ls, v, zs, zv, u, col, ls_t=None, v_t=None, col_t=None):
    """One ``step_qe`` update with its tangents written out: (log S, v)
    [N] and their tangents [c, N] (None: the primal alone); ``col``: the
    step's 12 table values, ``col_t``: their tangents, [c, 1] each."""
    e, ome, var_const, k0, k1, k2, k3, k4, rdt, theta, sigma, kappa = col
    d1 = v - theta
    d2 = d1 * e
    m = theta + d2
    sa = v * sigma
    sb = sa * sigma
    sc = sb * e
    sd = sc * ome
    se = sd / kappa
    s2 = se + var_const
    mm = m * m
    den = mm + _EPS
    psi = s2 / den
    pe = psi + _EPS
    rec = torch.reciprocal(pe)
    ip = rec * 1.0
    ti = 2.0 * ip
    tm = ti - 1.0
    tail = torch.clamp(tm, min=0.0)
    sq1 = torch.sqrt(ti)
    sq2 = torch.sqrt(tail)
    pr = sq1 * sq2
    bs = tm + pr
    b2 = torch.clamp(bs, min=0.0)
    opb = 1.0 + b2
    a = m / opb
    sbr = torch.sqrt(b2)
    sbz = sbr + zv
    sq = sbz ** 2
    vq = a * sq
    pm1 = psi - 1.0
    pp1 = psi + 1.0
    q = pm1 / pp1
    p = torch.clamp(q, 0.0, 1.0 - 1e-6)
    omp = 1.0 - p
    mpe = m + _EPS
    beta = omp / mpe
    c1 = torch.clamp(omp, min=_EPS)
    c2u = torch.clamp(1.0 - u, min=_EPS)
    ratio = c1 / c2u
    lg = torch.log(ratio)
    bpe = beta + _EPS
    vt = lg / bpe
    um = u - p
    wa = (um + 0.3) / (2.0 * 0.3)
    wm = torch.clamp(wa, 0.0, 1.0)
    ve = wm * vt
    wb = (psi - 1.5 + 0.5) / (2.0 * 0.5)
    w = torch.clamp(wb, 0.0, 1.0)
    omw = 1.0 - w
    tq = omw * vq
    te = w * ve
    vn = tq + te
    k3v = k3 * v
    k4vn = k4 * vn
    vi = k3v + k4vn
    var_int = torch.clamp(vi, min=0.0)
    vc = torch.clamp(var_int, min=_EPS)
    vol = torch.sqrt(vc)
    k1v = k1 * v
    k2vn = k2 * vn
    vz = vol * zs
    ls_next = ls + rdt + k0 + k1v + k2vn + vz
    if ls_t is None:
        return ls_next, vn, None, None

    e_t, ome_t, var_const_t, k0_t, k1_t, k2_t, k3_t, k4_t, rdt_t, theta_t, sigma_t, kappa_t = col_t
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    mul = lambda x, xt, y, yt: yt * x + xt * y
    div = lambda xt, y, yt, r: (xt - yt * r) / y
    keep = lambda cond, t: torch.where(cond, t, zero)
    d1_t = v_t - theta_t
    d2_t = mul(d1, d1_t, e, e_t)
    m_t = theta_t + d2_t
    sa_t = mul(v, v_t, sigma, sigma_t)
    sb_t = mul(sa, sa_t, sigma, sigma_t)
    sc_t = mul(sb, sb_t, e, e_t)
    sd_t = mul(sc, sc_t, ome, ome_t)
    se_t = div(sd_t, kappa, kappa_t, se)
    s2_t = se_t + var_const_t
    mm_t = mul(m, m_t, m, m_t)
    psi_t = div(s2_t, den, mm_t, psi)
    rec_t = (-psi_t) * (rec * rec)
    ti_t = (rec_t * 1.0) * 2.0
    tail_t = keep(tm >= 0.0, ti_t)
    sq1_t = ti_t / (2 * sq1)
    sq2_t = tail_t / (2 * sq2)
    pr_t = mul(sq1, sq1_t, sq2, sq2_t)
    b2_t = keep(bs >= 0.0, ti_t + pr_t)
    a_t = div(m_t, opb, b2_t, a)
    sbz_t = b2_t / (2 * sbr)
    sq_t = sbz_t * (2.0 * sbz)
    vq_t = mul(a, a_t, sq, sq_t)
    q_t = div(psi_t, pp1, psi_t, q)
    p_t = keep((q >= 0.0) & (q <= 1.0 - 1e-6), q_t)
    omp_t = -p_t
    beta_t = div(omp_t, mpe, m_t, beta)
    c1_t = keep(omp >= _EPS, omp_t)
    lg_t = (c1_t / c2u) / ratio
    vt_t = div(lg_t, bpe, beta_t, vt)
    wa_t = (-p_t) / (2.0 * 0.3)
    wm_t = keep((wa >= 0.0) & (wa <= 1.0), wa_t)
    ve_t = mul(wm, wm_t, vt, vt_t)
    w_t = keep((wb >= 0.0) & (wb <= 1.0), psi_t / (2.0 * 0.5))
    tq_t = mul(omw, -w_t, vq, vq_t)
    te_t = mul(w, w_t, ve, ve_t)
    vn_t = tq_t + te_t
    vi_t = mul(k3, k3_t, v, v_t) + mul(k4, k4_t, vn, vn_t)
    vc_t = keep(var_int >= _EPS, keep(vi >= 0.0, vi_t))
    vol_t = vc_t / (2 * vol)
    ls_next_t = (ls_t + rdt_t + k0_t + mul(k1, k1_t, v, v_t) + mul(k2, k2_t, vn, vn_t)
                 + vol_t * zs)
    return ls_next, vn, ls_next_t, vn_t


def qe_planes_reference(steps: torch.Tensor, z: torch.Tensor, u: torch.Tensor,
                        table: torch.Tensor, init: torch.Tensor, num_coarse: int,
                        table_t: Optional[torch.Tensor] = None,
                        init_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the primal plane [T, N, 2] or,
    given ``table_t`` [c, T', 12] and ``init_t`` [c, 2], its tangent
    planes [c, T, N, 2].

    ``steps``: [T', 2] (:func:`plan`); ``z``: [T', N, 2] and ``u``: [T', N]
    frozen draws, float32, each step's taken to float64 as
    ``_reconstruct`` does; ``table``: [T', 12] (:func:`columns`); ``init``:
    (log S0, v0)."""
    n = z.shape[1]
    ls, v = init[0].expand(n), init[1].expand(n)
    ls_t = v_t = None
    if table_t is not None:
        ls_t, v_t = init_t[:, 0, None].expand(-1, n), init_t[:, 1, None].expand(-1, n)
    planes = [None] * num_coarse
    for i, (live, emit) in enumerate(steps.tolist()):
        if live:
            zi, ui = z[i].to(table.dtype), u[i].to(table.dtype)
            col_t = None if table_t is None else table_t[:, i, :, None].unbind(1)
            ls, v, ls_t, v_t = _qe_step(ls, v, zi[:, 0], zi[:, 1], ui, table[i].unbind(0),
                                        ls_t, v_t, col_t)
        if emit >= 0:
            planes[emit] = torch.stack([ls, v] if table_t is None else [ls_t, v_t], dim=-1)
    return torch.stack(planes, dim=-3)


# -- the kernel -----------------------------------------------------------------------


def build_flags(num_tangents: int) -> Tuple[str, ...]:
    """The nvcc flags of a build: the tangent count (0: the primal)."""
    return (f"-DMCRE_C={num_tangents}",)


def load_builds(tangent_counts: Sequence[int]):
    """The kernel's builds for these tangent counts (0: the primal), the
    missing ones compiled concurrently."""
    return cuda_build.load_libraries(
        [("qe_tangents", build_flags(c)) for c in dict.fromkeys(tangent_counts)])


# mcre_qe_tangents's arguments.
_ARGS = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # out, z, u
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # steps, table, table_t
    ctypes.c_void_p, ctypes.c_void_p,                   # init, init_t
    ctypes.c_int, ctypes.c_int, ctypes.c_int,           # tangents, dense steps, coarse
    ctypes.c_uint32, ctypes.c_void_p,                   # paths, stream
)


def _launch(steps, z, u, table, init, table_t, init_t, out, c):
    lib = load_builds([c])["qe_tangents", build_flags(c)].lib
    fn = cuda_build.bind(lib, "mcre_qe_tangents", _ARGS)
    ptr = cuda_build.ptr
    rc = fn(out.data_ptr(), z.data_ptr(), u.data_ptr(), steps.data_ptr(), table.data_ptr(),
            ptr(table_t), init.data_ptr(), ptr(init_t), c, steps.shape[0], out.shape[-3],
            z.shape[1], torch.cuda.current_stream(out.device).cuda_stream)
    cuda_build.check(rc, "qe_tangents")
    qe_planes.launches[c] += 1


def _check(steps, z, u, table, init, num_coarse, table_t, init_t):
    t_dense, n = steps.shape[0], z.shape[1] if z.dim() == 3 else -1
    c = 0 if table_t is None else table_t.shape[0]
    if (table_t is None) != (init_t is None):
        raise ValueError("qe_tangents: the table's and the initial state's tangents go together")
    shapes = [(steps, (t_dense, 2)), (z, (t_dense, n, 2)), (u, (t_dense, n)),
              (table, (t_dense, len(COLUMNS))), (init, (2,)),
              (table_t, (c, t_dense, len(COLUMNS))), (init_t, (c, 2))]
    for x, shape in shapes:
        if x is not None and tuple(x.shape) != shape:
            raise ValueError(f"qe_tangents: an input of shape {tuple(x.shape)}, not {shape}")
    dtypes = [(steps, torch.int32), (z, torch.float32), (u, torch.float32)] + [
        (x, torch.float64) for x in (table, init, table_t, init_t)]
    for x, dtype in dtypes:
        if x is not None and (x.dtype != dtype or x.device != z.device):
            raise ValueError("qe_tangents takes int32 steps, float32 draws and float64 "
                             "parameters on one device")
    if num_coarse < 1 or n < 1:
        raise ValueError("qe_tangents: no coarse point or no path")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous at a 16-byte aligned address (the kernel's vector
    loads and stores), copied where it is not."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def qe_planes(steps: torch.Tensor, z: torch.Tensor, u: torch.Tensor, table: torch.Tensor,
              init: torch.Tensor, num_coarse: int, table_t: Optional[torch.Tensor] = None,
              init_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The rebuilt primal plane [T, N, 2] or, given ``table_t`` and
    ``init_t``, its tangent planes [c, T, N, 2] (arguments as
    :func:`qe_planes_reference`).  CPU tensors run the plain version; CUDA
    tensors launch the kernel, :data:`MAX_TANGENTS` tangents a launch."""
    _check(steps, z, u, table, init, num_coarse, table_t, init_t)
    if z.device.type == "cpu":
        return qe_planes_reference(steps, z, u, table, init, num_coarse, table_t, init_t)
    if z.device.type != "cuda":
        raise ValueError(f"qe_tangents: unsupported device {z.device}")
    shape = (num_coarse, z.shape[1], 2)
    steps, z, u, table, init = (_aligned(x) for x in (steps, z, u, table, init))
    with torch.cuda.device(z.device):
        if table_t is None:
            out = torch.empty(shape, dtype=torch.float64, device=z.device)
            _launch(steps, z, u, table, init, None, None, out, 0)
            return out
        table_t, init_t = _aligned(table_t), _aligned(init_t)
        c = table_t.shape[0]
        out = torch.empty((c, *shape), dtype=torch.float64, device=z.device)
        for j in range(0, c, MAX_TANGENTS):
            part = slice(j, j + MAX_TANGENTS)
            _launch(steps, z, u, table, init, table_t[part], init_t[part], out[part],
                    min(MAX_TANGENTS, c - j))
        return out


qe_planes.launches = collections.Counter()  # kernel launches by tangent count (0: primal)


# -- the binding under vmap(jvp) ------------------------------------------------------


@torch.library.custom_op("mcre::qe_tangents", mutates_args=())
def _tangents_op(num_coarse: int, steps: torch.Tensor, z: torch.Tensor, u: torch.Tensor,
                 table: torch.Tensor, init: torch.Tensor, table_t: torch.Tensor,
                 init_t: torch.Tensor) -> torch.Tensor:
    """The tangent plane [T, N, 2] of one direction (``table_t`` [T', 12],
    ``init_t`` [2])."""
    return qe_planes(steps, z, u, table, init, num_coarse, table_t.unsqueeze(0),
                     init_t.unsqueeze(0))[0]


@_tangents_op.register_vmap
def _tangents_vmap(info, in_dims, num_coarse, steps, z, u, table, init, table_t, init_t):
    """A sweep's c directions in one call: the batch dimension of the
    tangents to the front, [c, T, N, 2] out."""
    if any(d is not None for d in in_dims[1:6]):
        raise NotImplementedError("qe_tangents: only the tangents may carry a batch dimension")

    def batched(x, dim):
        return x.expand(info.batch_size, *x.shape) if dim is None else x.movedim(dim, 0)

    return qe_planes(steps, z, u, table, init, num_coarse, batched(table_t, in_dims[6]),
                     batched(init_t, in_dims[7])), 0


class _QE(torch.autograd.Function):
    """The rebuilt plane with forward-mode derivatives: the forward is the
    primal launch, the ``jvp`` the tangent launch of the custom op (under
    ``vmap``, one for the sweep's directions).  No backward: the route
    runs only under forward mode.  The draws carry no tangent."""

    generate_vmap_rule = True

    @staticmethod
    def forward(table, init, z, u, steps, num_coarse):
        return qe_planes(steps, z, u, table, init, num_coarse)

    @staticmethod
    def setup_context(ctx, inputs, output):
        table, init, z, u, steps, num_coarse = inputs
        ctx.save_for_forward(table, init, z, u, steps)
        ctx.num_coarse = num_coarse
        ctx.set_materialize_grads(False)  # no zeros for the inputs without a tangent

    @staticmethod
    def jvp(ctx, table_t, init_t, z_t, u_t, steps_t, _):
        if z_t is not None or u_t is not None or steps_t is not None:
            raise ValueError("qe_tangents: the frozen draws and the steps carry no tangent")
        table, init, z, u, steps = ctx.saved_tensors
        table_t = torch.zeros_like(table) if table_t is None else table_t
        init_t = torch.zeros_like(init) if init_t is None else init_t
        return _tangents_op(ctx.num_coarse, steps, z, u, table, init, table_t, init_t)


@functools.lru_cache(maxsize=32)
def _on_device(steps: bytes, dts: bytes, device: torch.device):
    """The step table and the dense dts on ``device``, uploaded once per
    plan and device through pinned memory, with no sync."""
    return (cuda_build.upload(np.array(np.frombuffer(steps, dtype=np.int32).reshape(-1, 2)),
                              device),
            cuda_build.upload(np.array(np.frombuffer(dts, dtype=np.float64)), device))


def model_supported(model, scheme) -> bool:
    """Whether the kernel rebuilds this model's emitted-noise route: its
    draws come from the Heston QE path kernel (``kernel_ad_mode`` "emit",
    ``supports_kernel_paths``: QE without the martingale correction), whose
    step the kernel repeats with the fuzzy branches (``perform_smoothing``);
    the noise transform is the identity and carries no tangent."""
    if not (model.kernel_ad_mode(scheme) == "emit" and model.supports_kernel_paths(scheme)
            and model.perform_smoothing):
        return False
    return _identity_transform(model, scheme)


_IDENTITY = weakref.WeakKeyDictionary()  # model -> {scheme: L is I and carries no tangent}


def _identity_transform(model, scheme) -> bool:
    """L(params) = I with a zero jacobian, at the model's parameters on the
    CPU; checked once per model and scheme."""
    known = _IDENTITY.setdefault(model, {})
    if scheme not in known:
        pvec = torch.stack(model.initial_params(device="cpu", dtype=torch.float64))
        transform = lambda p: model.noise_transform(tuple(p.unbind(0)), scheme)
        eye = torch.eye(model.simulation_dim, dtype=torch.float64)
        known[scheme] = (bool(torch.equal(transform(pvec), eye))
                         and not bool(torch.func.jacfwd(transform)(pvec).any()))
    return known[scheme]


def reconstruction(model, scheme, timeline: Sequence[float], num_steps: int, chunk: int):
    """``recon_fn(params, (z, u))``: the coarse plane [T, N, 2] rebuilt from
    the frozen draws by the kernel (the plain version on the CPU), with
    forward-mode derivatives; the same function of (params, z, u) as
    ``emitted_noise_fns``' ``recon_fn``.  ``chunk``: the jacobian's sweep
    size; the first call on the card loads the primal's build and those of
    every sweep's launches at once, compiling the missing ones
    concurrently."""
    if not model_supported(model, scheme):
        raise ValueError("qe_tangents rebuilds the fuzzy Heston QE step on emitted draws only")
    steps, dts, num_coarse = plan(float(model.calibration_date),
                                  tuple(float(t) for t in timeline), int(num_steps))

    def recon_fn(params, noise):
        z, u = noise
        device = params[0].device
        steps_d, dts_d = _on_device(steps.tobytes(), dts.tobytes(), device)
        if device.type == "cuda":
            load_builds([0, *cuda_build.launch_sizes(len(params), chunk, MAX_TANGENTS)])
        table, init = columns(model, params, dts_d.to(params[0].dtype))
        return _QE.apply(table, init, z, u, steps_d, num_coarse)

    return recon_fn
