"""Multi-chip sharding for the SLAM compute path.

The reference is a single-process shared-memory system (SURVEY.md §2.8);
its only parallelism is a 6-thread map-reduce over residual/point index
ranges (util/IndexThreadReduce.h). The accelerator equivalent of that
map-reduce is *data parallelism over the point axis*: residual
linearization, Hessian/Schur accumulation, and idepth resubstitution are
embarrassingly parallel over points, with one (D,D)-sized psum to stitch —
exactly what `jit` over a device mesh gives us with point arrays sharded on
a "dp" axis and everything else replicated.

Two sharded entry points:
  * `sharded_gn_step`: one windowed-BA Gauss-Newton step with the point pool
    sharded across the mesh. XLA inserts an AllReduce for the H/b einsums.
  * `sharded_track`: the multi-hypothesis coarse tracker with the hypothesis
    batch sharded across the mesh (each chip tracks a subset of motion
    hypotheses independently — zero communication).

Both compile and run on an N-virtual-device CPU mesh
(xla_force_host_platform_device_count) for the CPU dry-run
(`__graft_entry__.dryrun_multichip`). The mesh is a plain 1-D
`jax.devices()[:n]`; no production path uses it.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sos_slam_tpu.models import energy as E
from sos_slam_tpu.ops import ba as B
from sos_slam_tpu.ops import tracker as TK


def make_mesh(n_devices: int) -> Mesh:
    devs = jax.devices()[:n_devices]
    return Mesh(devs, ("dp",))


# BAState leaves with a leading point axis (shardable on "dp")
_POINT_FIELDS = {
    "pt_valid", "host", "u", "v", "color", "weight", "idepth", "idepth_zero",
    "pt_prior", "res_exist", "res_state",
}


def ba_shardings(mesh: Mesh) -> B.BAState:
    """A BAState-shaped pytree of NamedShardings: points on dp, rest replicated."""
    shard = NamedSharding(mesh, P("dp"))
    repl = NamedSharding(mesh, P())
    return B.BAState(**{
        f: (shard if f in _POINT_FIELDS else repl)
        for f in B.BAState._fields
    })


def shard_ba(ba: B.BAState, mesh: Mesh) -> B.BAState:
    return jax.device_put(ba, ba_shardings(mesh))


@functools.partial(jax.jit, static_argnames=("settings", "w", "h"))
def _gn_step(ba, dI, settings, w, h):
    ba2, canbreak, energy = E.gn_step(ba, dI, settings, w, h)
    return ba2, energy


def sharded_gn_step(mesh: Mesh, ba: B.BAState, dI, settings, w: int, h: int):
    """One BA GN step with the point pool sharded over the mesh."""
    ba = shard_ba(ba, mesh)
    dI = jax.device_put(dI, NamedSharding(mesh, P()))
    return _gn_step(ba, dI, settings, w, h)


@functools.partial(jax.jit, static_argnames=("settings", "w", "h"))
def _vio_gn_step(ba, imu, dI, settings, w, h):
    ba2, imu2, canbreak, energy = E.gn_step_vio(ba, imu, dI, settings, w, h)
    return ba2, imu2, energy


def sharded_vio_gn_step(mesh: Mesh, ba: B.BAState, imu, dI, settings,
                        w: int, h: int):
    """One visual-inertial GN step (vision linearization + IMU Hessian +
    KKT solve, EnergyFunctional::solveSystemF imu branch) with the point
    pool sharded on "dp" and the IMU/frame state replicated. The per-point
    linearization and Schur accumulation fan out across the mesh; XLA
    AllReduces the (D,D) stitches; the dense (5+29F+C) KKT solve runs
    replicated (it is tiny)."""
    ba = shard_ba(ba, mesh)
    repl = NamedSharding(mesh, P())
    imu = jax.device_put(imu, repl)
    dI = jax.device_put(dI, repl)
    return _vio_gn_step(ba, imu, dI, settings, w, h)


def sharded_track(mesh: Mesh, pyramid_new, templates, T_inits, aff0, ref_aff,
                  exposures, intrinsics, n_levels: int, **kw):
    """Batched hypothesis tracking with hypotheses sharded over the mesh."""
    T_inits = jax.device_put(T_inits, NamedSharding(mesh, P("dp")))
    return TK.track_hypotheses(
        pyramid_new, templates, T_inits, aff0, ref_aff, exposures,
        intrinsics, n_levels, **kw)


# ImmatureState leaves all carry a leading point axis (shardable on "dp")
def imm_shardings(mesh: Mesh, imm) -> object:
    shard = NamedSharding(mesh, P("dp"))
    return type(imm)(**{f: shard for f in imm._fields})


def sharded_trace(mesh: Mesh, ba: B.BAState, imm, dI0_new, T_cw_new, aff_new,
                  exposure_new, w: int, h: int, settings):
    """Epipolar trace of the immature pool sharded over the mesh: each chip
    traces a slice of the points against the (replicated) new frame — zero
    communication, like the reference's IndexThreadReduce over point ranges
    (util/IndexThreadReduce.h)."""
    from sos_slam_tpu.models import full_system as FSM
    imm = jax.device_put(imm, imm_shardings(mesh, imm))
    dI0_new = jax.device_put(dI0_new, NamedSharding(mesh, P()))
    return FSM._trace_jit(ba, imm, dI0_new, T_cw_new, aff_new,
                          exposure_new, w, h, settings)
