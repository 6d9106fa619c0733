"""Forward-mode path reconstruction: the CUDA kernel and its plain version.

Replaces no TPU kernel.  On the TPU the differentiated kernel route rebuilds
the path on the frozen draws (``montecarlo_risk_engine_tpu/ops/
pallas_paths_ad.py`` ``_reconstruct``) under ``jit``, and XLA fuses the
rebuild and its tangents into a few loops.  The port runs eagerly: under
``vmap(jvp)`` each op of ``model.step`` becomes a primal and a tangent kernel
over [c, N] float64, and the host's dispatch of those tens of thousands of
small kernels, not their bytes, sets the pace (PERF.md section 5).  This
kernel runs the whole rebuild of one phase in one launch.

What it computes: the coarse plane [T, N, D] of
``ops/paths_ad.recovered_noise_fns``' ``recon_fn`` (``_reconstruct`` on the
frozen standard normals z [T', N, sim_dim] of the substep-dense timeline)
or, given c tangents of the parameters, its c tangent planes [c, T, N, D],
for block lists of Vasicek, Black-Scholes and CIR++ Euler blocks (slot roles
``VAS_EULER``, ``GBM_EULER`` and ``CIRPP`` of ``ops/hybrid_paths``, one
noise factor per slot).  Per dense step, where it has length: noise = z L^T
summed over the factors in index order (``ops/noise.matmul_t``), then each
block's Euler step (``models/vasicek.py``, ``models/black_scholes.py``,
``models/cirpp.py`` ``step_euler``) in float64, op for op in their order,
each tangent by the rule ``torch.func.jvp`` applies to that op:

  * x * y: x' y + x y'; x + y, x - y: x' + y', x' - y'; x * k (a float): x' k;
  * sqrt(x): x' / (2 sqrt(x)) (inf or nan at 0, as torch gives);
  * clamp(x, min=m): x' where x >= m (the tie included), else 0;
  * a value with no tangent (dt, sqrt(dt), z, L and so the noise) adds no
    product.  L has none on these blocks: their correlation is static under
    EULER, and the route refuses an L that carries a tangent.

CIR++'s shift psi(params, t1) comes in as a column per dense step with its
tangents, computed in torch by :meth:`CIRPPModel.psi` over every dense time
in one vectorised call.  The initial state is the blocks' ``init_state``:
the parameter of each state column or 0.

:func:`recon_planes` dispatches on the device: CPU tensors run
:func:`recon_planes_reference`, the recurrence in plain torch with the
tangent arithmetic written out; CUDA tensors launch
``csrc/recon_tangents.cu`` (one build per tuple of slot roles and tangent
count, at most :data:`MAX_TANGENTS` a launch, counted by tangent count in
``recon_planes.launches``) or raise.  Under ``vmap(jvp)``
the route's ``torch.autograd.Function`` gives the primal plane in its
forward and the tangent planes in its ``jvp`` through the custom op
``mcre::recon_tangents``, whose vmap rule hands the sweep's c tangents to
one launch.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from montecarlo_risk_engine_tpu_torch.ops import cuda_build
from montecarlo_risk_engine_tpu_torch.ops.hybrid_paths import (
    CIRPP, GBM_EULER, VAS_EULER, KernelBlock, kernel_slots,
)
from montecarlo_risk_engine_tpu_torch.ops.paths_ad import _schedule, dense_timeline

# csrc/recon_tangents.cu: the most tangents a launch carries (more go in
# several launches) and the most noise factors (= slots).
MAX_TANGENTS = 8
MAX_SLOTS = 8
ROLES = (GBM_EULER, VAS_EULER, CIRPP)
_Y_FLOOR = 1e-12  # models/cirpp.py step_euler


class Layout(NamedTuple):
    """The static half of the rebuild: per slot its role, parameter indices
    (``pa``, ``pb`` as in ``ops/hybrid_paths.Slot``) and output columns
    (``ob`` -1: none); per state column the parameter it starts from (-1:
    0); the number of coarse points."""

    roles: Tuple[int, ...]
    pa: Tuple[int, ...]
    pb: Tuple[int, ...]
    oa: Tuple[int, ...]
    ob: Tuple[int, ...]
    init: Tuple[int, ...]
    num_coarse: int

    @property
    def state_dim(self) -> int:
        return len(self.init)

    def flat(self) -> List[int]:
        """The layout as one int list (an argument of the custom op)."""
        return [len(self.roles), len(self.init), self.num_coarse, *self.roles, *self.pa,
                *self.pb, *self.oa, *self.ob, *self.init]

    @classmethod
    def of_flat(cls, xs: Sequence[int]) -> "Layout":
        ns, dim, coarse = xs[:3]
        cut = [3 + ns * k for k in range(6)]
        parts = [tuple(int(v) for v in xs[cut[k]:cut[k + 1]]) for k in range(5)]
        return cls(*parts, tuple(int(v) for v in xs[cut[5]:cut[5] + dim]), int(coarse))


def supported(blocks: Optional[Sequence[KernelBlock]]) -> bool:
    """Whether the kernel rebuilds this block list: Vasicek, Black-Scholes
    and CIR++ (stochastic) Euler blocks only, at most :data:`MAX_SLOTS`."""
    return (bool(blocks) and len(blocks) <= MAX_SLOTS
            and all(b is not None and b.scheme == "euler"
                    and b.kind in ("vasicek", "bs", "cirpp") for b in blocks))


@functools.lru_cache(maxsize=32)
def plan(blocks: Tuple[KernelBlock, ...], calibration_date: float, timeline: Tuple[float, ...],
         num_steps: int):
    """(layout, steps [T', 4] float64, dense times [T']) of a block list on
    a timeline: per dense step (live, dt, sqrt(dt), coarse point it emits or
    -1) with dt = t2 - t1 and sqrt(dt) as ``model.step`` forms them from
    (t1, t2) = (t_prev, t_prev + dt), and its start t_prev (psi's time)."""
    slots, state_dim, _ = kernel_slots(blocks)
    init, off = [-1] * state_dim, 0
    for b in blocks:  # r0, spot or y0; log_B starts at 0
        init[off] = b.param_base + (3 if b.kind == "cirpp" else 0)
        off += b.n_state
    dense, orig_idx = dense_timeline(calibration_date, timeline, num_steps)
    emit = np.full(len(dense), -1.0)
    emit[orig_idx] = np.arange(len(orig_idx))
    rows, times = [], []
    for (t_prev, dt), e in zip(_schedule(calibration_date, dense), emit):
        step = (t_prev + dt) - t_prev
        rows.append((1.0, step, math.sqrt(step), e) if dt > 0.0 else (0.0, 0.0, 0.0, e))
        times.append(t_prev)
    layout = Layout(tuple(s.role for s in slots), tuple(s.pa for s in slots),
                    tuple(s.pb for s in slots), tuple(s.oa for s in slots),
                    tuple(s.ob for s in slots), tuple(init), len(orig_idx))
    steps = np.asarray(rows, dtype=np.float64).reshape(len(rows), 4)
    return layout, steps, tuple(times)


# -- the plain version ----------------------------------------------------------------


class _Dual(NamedTuple):
    """A value and its tangents ([c, ...]; None: no tangent, as for a
    float or a tensor that does not depend on the parameters)."""

    v: object
    t: Optional[torch.Tensor]


def _add(x, y):
    return _Dual(x.v + y.v, x.t if y.t is None else y.t if x.t is None else x.t + y.t)


def _sub(x, y):
    return _Dual(x.v - y.v, x.t if y.t is None else -y.t if x.t is None else x.t - y.t)


def _mul(x, y):
    if x.t is None:
        t = None if y.t is None else x.v * y.t
    else:
        t = x.t * y.v if y.t is None else x.t * y.v + x.v * y.t
    return _Dual(x.v * y.v, t)


def _sqrt(x):
    v = torch.sqrt(x.v)
    return _Dual(v, None if x.t is None else x.t / (2 * v))


def _clamp_min(x, m: float):
    t = None if x.t is None else torch.where(x.v >= m, x.t, torch.zeros_like(x.t))
    return _Dual(torch.clamp(x.v, min=m), t)


def recon_planes_reference(layout: Layout, steps: torch.Tensor, z: torch.Tensor,
                           params: torch.Tensor, psi: torch.Tensor, chol: torch.Tensor,
                           params_t: Optional[torch.Tensor] = None,
                           psi_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the primal plane [T, N, D] or,
    given ``params_t`` [c, P], its tangent planes [c, T, N, D].

    ``steps``: [T', 4] (:func:`plan`); ``z``: [T', N, S] frozen normals;
    ``params``: [P]; ``psi``: [K, T'], one row per CIR++ slot in slot order;
    ``chol``: [S, S] noise transform (no tangent).  ``psi_t`` [c, K, T'] may
    be None (no tangent)."""
    n = z.shape[1]
    tangents = params_t is not None
    col = lambda x: x[:, None]  # [c] -> [c, 1] against [c, N]

    def param(i):
        return _Dual(params[i], col(params_t[:, i]) if tangents else None)

    def start(i):
        if i < 0:
            return _Dual(torch.zeros(n, dtype=params.dtype, device=params.device),
                         torch.zeros((params_t.shape[0], n), dtype=params.dtype,
                                     device=params.device) if tangents else None)
        return _Dual(params[i].expand(n), col(params_t[:, i]).expand(-1, n) if tangents else None)

    ns = len(layout.roles)
    a = [start(layout.init[layout.oa[s]]) for s in range(ns)]
    b = [start(layout.init[layout.ob[s]]) if layout.ob[s] >= 0 else None for s in range(ns)]
    psi_row = np.cumsum([r == CIRPP for r in layout.roles]) - 1
    planes = [None] * layout.num_coarse
    for i, (live, dt, sqrt_dt, emit) in enumerate(steps.tolist()):
        if live:
            zi = z[i]
            noise = []
            for s in range(ns):
                v = zi[:, 0] * chol[s, 0]
                for k in range(1, zi.shape[1]):
                    v = v + zi[:, k] * chol[s, k]
                noise.append(_Dual(v, None))
            dt_, sqrt_dt_ = _Dual(dt, None), _Dual(sqrt_dt, None)
            for s, role in enumerate(layout.roles):
                pa = layout.pa[s]
                if role == GBM_EULER:  # S + r S dt + sigma S sqrt(dt) w
                    sigma, rate, x = param(pa), param(layout.pb[s]), a[s]
                    a[s] = _add(_add(x, _mul(_mul(rate, x), dt_)),
                                _mul(_mul(_mul(sigma, x), sqrt_dt_), noise[s]))
                elif role == VAS_EULER:  # log_B + r dt; r + a (theta - r) dt + sigma sqrt(dt) w
                    sigma, theta, speed, r = param(pa), param(pa + 1), param(pa + 2), a[s]
                    b[s] = _add(b[s], _mul(r, dt_))
                    a[s] = _add(_add(r, _mul(_mul(speed, _sub(theta, r)), dt_)),
                                _mul(_mul(sigma, sqrt_dt_), noise[s]))
                else:  # CIRPP: full-truncation Euler on y, log_B + (y + psi) dt
                    kappa, theta, sigma, y = param(pa), param(pa + 1), param(pa + 2), a[s]
                    k = int(psi_row[s])
                    shift = _Dual(psi[k, i], col(psi_t[:, k, i]) if tangents and psi_t is not None
                                  else None)
                    sqrt_y = _sqrt(_clamp_min(y, 0.0))
                    y_next = _add(_add(y, _mul(_mul(kappa, _sub(theta, y)), dt_)),
                                  _mul(_mul(_mul(sigma, sqrt_y), sqrt_dt_), noise[s]))
                    b[s] = _add(b[s], _mul(_add(y, shift), dt_))
                    a[s] = _clamp_min(y_next, _Y_FLOOR)
        if emit >= 0:
            cols = [None] * layout.state_dim
            for s in range(ns):
                cols[layout.oa[s]] = a[s].t if tangents else a[s].v
                if layout.ob[s] >= 0:
                    cols[layout.ob[s]] = b[s].t if tangents else b[s].v
            planes[int(emit)] = torch.stack(cols, dim=-1)
    return torch.stack(planes, dim=-3)


# -- the kernel -----------------------------------------------------------------------


def build_flags(layout: Layout, num_tangents: int) -> Tuple[str, ...]:
    """The nvcc flags of a build: the slot count and roles (4 bits a slot,
    as K2's ``role_flags``) and the tangent count (0: the primal)."""
    roles = sum(r << (4 * s) for s, r in enumerate(layout.roles))
    return (f"-DMCRE_NS={len(layout.roles)}", f"-DMCRE_ROLES={roles:#x}",
            f"-DMCRE_C={num_tangents}")


def load_builds(layout: Layout, tangent_counts: Sequence[int]):
    """The kernel's builds for these tangent counts (0: the primal), the
    missing ones compiled concurrently."""
    return cuda_build.load_libraries(
        [("recon_tangents", build_flags(layout, c)) for c in dict.fromkeys(tangent_counts)])


_INT_P = ctypes.POINTER(ctypes.c_int)
# mcre_recon_tangents's arguments.
_ARGS = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,     # out, z, steps
    ctypes.c_void_p, ctypes.c_void_p,                      # params, params_t
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,     # psi, psi_t, chol
    ctypes.c_int, ctypes.c_int,                            # slots, tangents
    _INT_P, _INT_P, _INT_P, _INT_P, _INT_P,                # role, pa, pb, oa, ob
    ctypes.c_int, _INT_P,                                  # state_dim, init
    ctypes.c_int, ctypes.c_int, ctypes.c_int,              # params, dense steps, coarse
    ctypes.c_uint32, ctypes.c_void_p,                      # paths, stream
)


@functools.lru_cache(maxsize=32)
def _descriptors(layout: Layout):
    ints = lambda xs: (ctypes.c_int * max(len(xs), 1))(*xs)
    return (ints(layout.roles), ints(layout.pa), ints(layout.pb), ints(layout.oa),
            ints(layout.ob), layout.state_dim, ints(layout.init))


def _launch(layout, steps, z, params, psi, chol, params_t, psi_t, out, c):
    lib = load_builds(layout, [c])["recon_tangents", build_flags(layout, c)].lib
    fn = cuda_build.bind(lib, "mcre_recon_tangents", _ARGS)
    role, pa, pb, oa, ob, dim, init = _descriptors(layout)
    ptr = cuda_build.ptr
    rc = fn(out.data_ptr(), z.data_ptr(), steps.data_ptr(), params.data_ptr(), ptr(params_t),
            ptr(psi), ptr(psi_t), chol.data_ptr(), len(layout.roles), c, role, pa, pb, oa,
            ob, dim, init, params.shape[0], steps.shape[0], layout.num_coarse, z.shape[1],
            torch.cuda.current_stream(out.device).cuda_stream)
    cuda_build.check(rc, "recon_tangents")
    recon_planes.launches[c] += 1


def _check(layout, steps, z, params, psi, chol, params_t, psi_t):
    ns, t_dense = len(layout.roles), steps.shape[0]
    k = sum(r == CIRPP for r in layout.roles)
    if any(r not in ROLES for r in layout.roles) or not 1 <= ns <= MAX_SLOTS:
        raise ValueError(f"recon_tangents has no rebuild of the roles {layout.roles}")
    c = 0 if params_t is None else params_t.shape[0]
    shapes = [(steps, (t_dense, 4)), (psi, (k, t_dense)), (chol, (ns, ns)),
              (params_t, (c, params.shape[0])), (psi_t, (c, k, t_dense))]
    if z.dim() != 3 or z.shape[0] != t_dense or z.shape[2] != ns or params.dim() != 1:
        raise ValueError(f"recon_tangents: z {tuple(z.shape)} against {t_dense} dense steps, "
                         f"{ns} factors; params {tuple(params.shape)}")
    for x, shape in shapes:
        if x is not None and tuple(x.shape) != shape:
            raise ValueError(f"recon_tangents: an input of shape {tuple(x.shape)}, not {shape}")
    for x in (steps, z, params, psi, chol, params_t, psi_t):
        if x is not None and (x.dtype != torch.float64 or x.device != z.device):
            raise ValueError("recon_tangents takes float64 tensors on one device")
    if max(layout.init + layout.pa + layout.pb) >= params.shape[0]:
        raise ValueError("recon_tangents: a slot's parameters lie beyond the parameter vector")


def recon_planes(layout: Layout, steps: torch.Tensor, z: torch.Tensor, params: torch.Tensor,
                 psi: torch.Tensor, chol: torch.Tensor, params_t: Optional[torch.Tensor] = None,
                 psi_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The rebuilt primal plane [T, N, D] or, given ``params_t`` [c, P],
    its tangent planes [c, T, N, D] (arguments as
    :func:`recon_planes_reference`).  CPU tensors run the plain version;
    CUDA tensors launch the kernel, :data:`MAX_TANGENTS` tangents a launch."""
    _check(layout, steps, z, params, psi, chol, params_t, psi_t)
    if z.device.type == "cpu":
        return recon_planes_reference(layout, steps, z, params, psi, chol, params_t, psi_t)
    if z.device.type != "cuda":
        raise ValueError(f"recon_tangents: unsupported device {z.device}")
    shape = (layout.num_coarse, z.shape[1], layout.state_dim)
    contiguous = lambda x: None if x is None else x.contiguous()
    z, steps, params, psi, chol = (x.contiguous() for x in (z, steps, params, psi, chol))
    with torch.cuda.device(z.device):
        if params_t is None:
            out = torch.empty(shape, dtype=torch.float64, device=z.device)
            _launch(layout, steps, z, params, psi, chol, None, None, out, 0)
            return out
        params_t, psi_t = contiguous(params_t), contiguous(psi_t)
        c = params_t.shape[0]
        out = torch.empty((c, *shape), dtype=torch.float64, device=z.device)
        for j in range(0, c, MAX_TANGENTS):
            part = slice(j, j + MAX_TANGENTS)
            _launch(layout, steps, z, params, psi, chol, params_t[part],
                    None if psi_t is None else psi_t[part], out[part], min(MAX_TANGENTS, c - j))
        return out


recon_planes.launches = collections.Counter()  # kernel launches by tangent count (0: primal)


# -- the binding under vmap(jvp) ------------------------------------------------------


@torch.library.custom_op("mcre::recon_tangents", mutates_args=())
def _tangents_op(layout: List[int], steps: torch.Tensor, z: torch.Tensor, params: torch.Tensor,
                 psi: torch.Tensor, chol: torch.Tensor, params_t: torch.Tensor,
                 psi_t: Optional[torch.Tensor]) -> torch.Tensor:
    """The tangent plane [T, N, D] of one direction (``params_t`` [P],
    ``psi_t`` [K, T'])."""
    return recon_planes(Layout.of_flat(layout), steps, z, params, psi, chol,
                        params_t.unsqueeze(0), None if psi_t is None else psi_t.unsqueeze(0))[0]


@_tangents_op.register_vmap
def _tangents_vmap(info, in_dims, layout, steps, z, params, psi, chol, params_t, psi_t):
    """A sweep's c directions in one call: the batch dimension of the
    tangents to the front, [c, T, N, D] out."""
    if any(d is not None for d in in_dims[1:6]):
        raise NotImplementedError("recon_tangents: only the tangents may carry a batch dimension")

    def batched(x, dim):
        if x is None:
            return None
        return x.expand(info.batch_size, *x.shape) if dim is None else x.movedim(dim, 0)

    tangents = [batched(x, d) for x, d in zip((params_t, psi_t), in_dims[6:])]
    return recon_planes(Layout.of_flat(layout), steps, z, params, psi, chol, *tangents), 0


class _Recon(torch.autograd.Function):
    """The rebuilt plane with forward-mode derivatives: the forward is the
    primal launch, the ``jvp`` the tangent launch of the custom op (under
    ``vmap``, one for the sweep's directions).  No backward: the route
    runs only under forward mode.  L may carry no tangent."""

    generate_vmap_rule = True

    @staticmethod
    def forward(params, psi, chol, z, steps, layout):
        return recon_planes(layout, steps, z, params, psi, chol)

    @staticmethod
    def setup_context(ctx, inputs, output):
        params, psi, chol, z, steps, layout = inputs
        ctx.save_for_forward(params, psi, chol, z, steps)
        ctx.layout = layout
        ctx.set_materialize_grads(False)  # no zeros for the inputs without a tangent

    @staticmethod
    def jvp(ctx, params_t, psi_t, chol_t, z_t, steps_t, _):
        if chol_t is not None or z_t is not None or steps_t is not None:
            raise ValueError("recon_tangents: L, the frozen draws and the steps carry no tangent")
        params, psi, chol, z, steps = ctx.saved_tensors
        if params_t is None:
            params_t = torch.zeros_like(params)
        return _tangents_op(ctx.layout.flat(), steps, z, params, psi, chol, params_t, psi_t)


@functools.lru_cache(maxsize=32)
def _on_device(steps: bytes, times: Tuple[float, ...], device: torch.device):
    """The step table and the dense times on ``device`` (float64), uploaded
    once per plan and device through pinned memory, with no sync."""
    return tuple(cuda_build.upload(np.array(host, dtype=np.float64), device)
                 for host in (np.frombuffer(steps, dtype=np.float64).reshape(-1, 4),
                              np.asarray(times)))


def model_blocks(model, scheme):
    """[(sub-model, param_base, block)] of K2's descriptors in block order:
    a ModelConfig's Euler blocks, or a model alone as its one block."""
    subs = getattr(model, "models", None)
    if subs is None:
        return [(model, 0, model.kernel_block(scheme))]
    blocks = model.kernel_blocks() or [None] * len(subs)
    return [(m, int(model._param_offsets[i]), b) for i, (m, b) in enumerate(zip(subs, blocks))]


def model_supported(model, scheme) -> bool:
    """Whether the kernel rebuilds this model's differentiated kernel route:
    draws recovered from the states (``kernel_ad_mode`` "invert") and a
    block list :func:`supported` takes."""
    return (model.kernel_ad_mode(scheme) == "invert"
            and supported([b for _, _, b in model_blocks(model, scheme)]))


def model_plan(model, scheme, timeline: Sequence[float], num_steps: int):
    """:func:`plan` of a model's block list; raises for a block list
    :func:`supported` refuses."""
    blocks = tuple(b for _, _, b in model_blocks(model, scheme))
    if not supported(blocks):
        raise ValueError("recon_tangents rebuilds Vasicek, Black-Scholes and CIR++ Euler blocks "
                         "only")
    return plan(blocks, float(model.calibration_date), tuple(float(t) for t in timeline),
                int(num_steps))


def psi_columns(model, scheme, params, times: torch.Tensor) -> torch.Tensor:
    """[K, T']: each CIR++ block's psi(params, t) at the dense times, in
    block order, by :meth:`CIRPPModel.psi` over all times at once (a zero-row
    tensor without CIR++ blocks)."""
    cols = [m.psi(tuple(params[base:base + 4]), times)
            for m, base, b in model_blocks(model, scheme) if b.kind == "cirpp"]
    return torch.stack(cols) if cols else times.new_zeros((0, times.shape[0]))


def reconstruction(model, scheme, timeline: Sequence[float], num_steps: int,
                   chunk: Optional[int] = None):
    """``recon_fn(params, z)``: the coarse plane [T, N, D] rebuilt from the
    frozen draws z [T', N, sim_dim] by the kernel (the plain version on the
    CPU), with forward-mode derivatives; the same function of (params, z)
    as ``recovered_noise_fns``' ``recon_fn``.  ``chunk``: the jacobian's
    sweep size; given, the first call on the card loads the primal's build
    and those of every sweep's launches (``cuda_build.launch_sizes``) at once,
    compiling the missing ones concurrently; else each loads at its first
    launch."""
    layout, steps, times = model_plan(model, scheme, timeline, num_steps)

    def recon_fn(params, z):
        dtype, device = params[0].dtype, params[0].device
        steps_d, times_d = _on_device(steps.tobytes(), times, device)
        if device.type == "cuda" and chunk:
            load_builds(layout, [0, *cuda_build.launch_sizes(len(params), chunk, MAX_TANGENTS)])
        psi = psi_columns(model, scheme, params, times_d.to(dtype))
        chol = model.noise_transform(params, scheme).to(dtype)
        return _Recon.apply(torch.stack(params), psi, chol, z.to(dtype), steps_d, layout)

    return recon_fn
