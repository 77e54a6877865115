"""Configuration pytrees and static simulation config.

The reference gym configures vehicles with a plain dict of 18 floats threaded
through every call (reference: gym/f110_gym/envs/f110_env.py:128,
base_classes.py:68-91).  Here the same fields become a `VehicleParams`
NamedTuple — a JAX pytree of arrays, so parameters can be batched per agent
and per env, donated to jit, and swept with `vmap` for population-based
tuning (the reference's CMA param-search use case,
examples/config_example_map.yaml).

`SimConfig` holds everything that must be static at trace time (shapes,
integrator choice, beam counts).  It is hashable so jitted step functions can
close over it.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, NamedTuple, Optional

import jax.numpy as jnp


class Integrator(enum.Enum):
    """Time integrator for the vehicle ODE (reference: base_classes.py:40-42)."""

    RK4 = 1
    EULER = 2


class VehicleParams(NamedTuple):
    """Vehicle physical parameters.

    Field names and defaults follow the reference parameter dict
    (reference: gym/f110_gym/envs/f110_env.py:67-128).  Every field is an
    array; fields may be scalars or carry leading (env, agent) batch axes —
    all dynamics kernels broadcast against the state's batch axes.
    """

    mu: jnp.ndarray        # surface friction coefficient
    C_Sf: jnp.ndarray      # front cornering stiffness coefficient
    C_Sr: jnp.ndarray      # rear cornering stiffness coefficient
    lf: jnp.ndarray        # CoG -> front axle distance [m]
    lr: jnp.ndarray        # CoG -> rear axle distance [m]
    h: jnp.ndarray         # CoG height [m]
    m: jnp.ndarray         # mass [kg]
    I: jnp.ndarray         # yaw moment of inertia [kg m^2]
    s_min: jnp.ndarray     # min steering angle [rad]
    s_max: jnp.ndarray     # max steering angle [rad]
    sv_min: jnp.ndarray    # min steering velocity [rad/s]
    sv_max: jnp.ndarray    # max steering velocity [rad/s]
    v_switch: jnp.ndarray  # wheel-spin switching velocity [m/s]
    a_max: jnp.ndarray     # max acceleration [m/s^2]
    v_min: jnp.ndarray     # min longitudinal velocity [m/s]
    v_max: jnp.ndarray     # max longitudinal velocity [m/s]
    width: jnp.ndarray     # car body width [m]
    length: jnp.ndarray    # car body length [m]

    @classmethod
    def default(cls, dtype=jnp.float32) -> "VehicleParams":
        """Default F1TENTH car (reference: f110_env.py:128)."""
        d = DEFAULT_PARAMS_DICT
        return cls(**{k: jnp.asarray(v, dtype=dtype) for k, v in d.items()})

    @classmethod
    def from_dict(cls, d: dict, dtype=jnp.float32) -> "VehicleParams":
        unknown = set(d) - set(cls._fields)
        if unknown:
            raise KeyError(f"unknown vehicle params: {sorted(unknown)}")
        merged = dict(DEFAULT_PARAMS_DICT)
        merged.update(d)
        return cls(**{k: jnp.asarray(merged[k], dtype=dtype) for k in cls._fields})

    def replace(self, **kw) -> "VehicleParams":
        return self._replace(**{k: jnp.asarray(v, dtype=self.mu.dtype) for k, v in kw.items()})


DEFAULT_PARAMS_DICT = {
    "mu": 1.0489,
    "C_Sf": 4.718,
    "C_Sr": 5.4562,
    "lf": 0.15875,
    "lr": 0.17145,
    "h": 0.074,
    "m": 3.74,
    "I": 0.04712,
    "s_min": -0.4189,
    "s_max": 0.4189,
    "sv_min": -3.2,
    "sv_max": 3.2,
    "v_switch": 7.319,
    "a_max": 9.51,
    "v_min": -5.0,
    "v_max": 20.0,
    "width": 0.31,
    "length": 0.58,
}


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static (trace-time) simulation configuration.

    Mirrors the kwargs of the reference env constructor
    (reference: f110_env.py:100-157) minus anything that is a runtime array.
    Hashable so jitted functions can specialize on it.
    """

    num_agents: int = 2
    num_beams: int = 1080
    fov: float = 2.0 * math.pi          # fork delta: default 2*pi (f110_env.py:157)
    timestep: float = 0.01
    ego_idx: int = 0
    integrator: Integrator = Integrator.RK4
    # lidar
    theta_dis: int = 2000               # angle discretization bins (laser_models.py:360)
    max_range: float = 30.0
    eps: float = 0.0001                 # ray-march termination distance
    scan_noise_std: float = 0.01        # gaussian beam noise (laser_models.py:429)
    # iTTC wall-collision threshold (base_classes.py:113)
    ttc_thresh: float = 0.005
    # scan-noise generation.  "pool" (default): precompute
    # noise_pool_rows exact threefry N(0, sigma) beam-rows once; each
    # env/step draws ONE row index from its per-step RNG key
    # (env._noise_row: a single randint + contiguous row fetch instead of
    # num_beams fresh normals per env and step).  Same marginal
    # distribution (rows ARE exact gaussians; moments/uniformity gated by
    # tests/test_infra.py::test_noise_pool_statistics_match_fresh),
    # deterministic under the same key.  The one statistical difference
    # from "fresh" is cross-env row sharing within a step (~envs/rows envs
    # see the same row), which is zero-mean and cannot bias a gradient
    # expectation — analysis in docs/performance.md.  "fresh": one threefry
    # draw per env per step — the reference's exact semantics
    # (laser_models.py:450-452); use for noise-stream-sensitive studies,
    # not for anything cryptographic either way.
    noise_mode: str = "pool"
    noise_pool_rows: int = 1024
    # steering delay depth (base_classes.py:107)
    steer_delay: int = 2
    # finish-line geometry (f110_env.py:216-230)
    finish_band_halfwidth: float = 2.0
    finish_dist2: float = 0.1
    laps_to_finish_toggles: int = 4     # 4 toggles == 2 laps
    # numerics
    dtype: str = "float32"
    # ray-march iteration strategy: 0 -> while_loop until every beam
    # terminates; >0 -> fixed budget fori_loop (static unroll for pipelines)
    march_iters: int = 0
    # lidar mode: "exact" = reference-parity sphere march per beam;
    # "fast" = precomputed range texture R(x, y, theta) + trilinear lookup
    # (the BASELINE north-star design: one gather instead of a march)
    scan_mode: str = "exact"
    rt_theta_bins: int = 128      # angular bins of the range texture
    rt_pose_stride: int = 2       # texture cell = stride * map resolution
    # fast-scan theta interpolation.  "linear" (default): exact linear lerp
    # between theta bins (matches trace_fast).  "spectral": the full real-
    # valued roll goes into the DFT phase and beams are evaluated by one
    # constant matrix — no 3-tap elementwise tail (fastest), trigonometric
    # interpolation semantics with a Lanczos anti-ringing window.
    scan_interp: str = "linear"
    # range-texture STORAGE dtype.  "auto": bfloat16 when running float32
    # (throughput mode) — halves the dominant texture-row gather bytes at a
    # ~0.4% range quantization, the same order as the sensor noise the reference
    # injects (sigma = 1 cm, laser_models.py:429) — and full precision in
    # float64 parity mode.  Explicit "float32"/"bfloat16" override.
    # Interpolation/matmul COMPUTE always stays >= float32.
    rt_dtype: str = "auto"
    # fast-scan spatial lookup.  "nearest1" (default): ONE rounded-cell row
    # gather — the texture-row gather is the hottest kernel of the whole
    # step, and with the gradient channels (rt_grad) correcting the pose
    # offset to first order it reaches bilinear-class accuracy (CPU study
    # on the reference example map: median 2.5 cm -> 3.1 cm is the whole
    # gap at shipped settings); a
    # pose whose nearest cell center is occupied reads scan 0 — defensible
    # because such a pose is within ~cell/sqrt(2) of a wall, inside the
    # car's own half-width, i.e. already physically colliding.
    # "bilinear": blend the 4 surrounding cells — 4 row gathers, slightly
    # better median/p90, second-order accurate with rt_grad.  "nearest":
    # single best of the 4 (one-hot blend) — no pose-offset correction
    # benefit over nearest1; kept for ablation.
    rt_spatial: str = "nearest1"
    # occlusion handling for the fast scan's theta interpolation (applies to
    # scan_interp="linear"; "spectral" has no per-tap pipeline and relies on
    # its Lanczos window instead):
    #   "off"  — plain lerp between theta taps: blends foreground/background
    #            ranges across visibility discontinuities (multi-meter
    #            phantom ranges on the 2-4% of beams near occlusion edges)
    #   "snap" — runtime-only: where adjacent taps jump by more than
    #            rt_occlusion_cells * cell, snap to the nearer tap instead
    #            of lerping (no extra texture channels)
    #   "edge" — default: the texture stores per bin-pair the sub-bin edge
    #            position e (bisection-refined at build) and transition
    #            width w (0 = hard visibility edge -> step, 1 = smooth ->
    #            lerp); beams render a parallax-corrected ramp through the
    #            stored knots.  Smooth-but-steep pairs (grazing walls) get
    #            w ~= 1 automatically, so misclassification degrades to the
    #            plain lerp, never to a spurious step.
    rt_occlusion: str = "edge"
    # build-time edge-detection threshold in texture-cell units (also the
    # runtime snap threshold for rt_occlusion="snap")
    rt_occlusion_cells: float = 2.0
    # bisection refinements of the e channel at build (sub-bin precision
    # 2^-iters of a theta bin)
    rt_edge_iters: int = 6
    # pose-gradient channels: store dR/dx, dR/dy (analytic, from the wall
    # tangent of adjacent hit points) and apply the first-order range
    # correction for the pose's offset from the texture cell center before
    # any interpolation — "nearest1" reaches bilinear-class accuracy from a
    # single row gather; bilinear gains second-order accuracy.
    rt_grad: bool = True
    # dtype of the edge-channel (e, w) shuffle matmul + intermediate.  The
    # (e, w) channels are sub-bin edge positions and widths in [0, 1]; a
    # bfloat16 ulp there (~2^-9) moves the rendered ramp by <0.2% of a
    # theta bin — far inside the edge channel's own bisection precision
    # (rt_edge_iters) — while halving the tap-intermediate bytes of the XLA
    # edge path.  "auto": bfloat16 when tracing for the GPU, the scan dtype
    # elsewhere (CPU matmuls have no fast bf16 path); "float32" means "no
    # bf16" (f64 scans keep f64 taps); ops/scan_fast._resolve_ew_dtype.
    rt_ew_dtype: str = "auto"
    # fork delta (reference base_classes.py:68,91,280): pluggable low-level
    # controller mapping (speed_cmd, steer_cmd, v, steer, sv_max, a_max,
    # v_max, v_min) -> (accl, steer_vel).  None -> ops.dynamics.pid (the
    # reference default).  Must be a pure jnp function; it is trace-time
    # static (part of the compiled program), matching the reference's
    # construction-time injection.
    speed_controller: Optional[Callable] = None

    def __post_init__(self):
        if self.scan_mode not in ("exact", "fast"):
            raise ValueError(f"scan_mode must be 'exact' or 'fast', got "
                             f"{self.scan_mode!r}")
        if self.scan_interp not in ("linear", "spectral"):
            raise ValueError(f"scan_interp must be 'linear'|'spectral', got "
                             f"{self.scan_interp!r}")
        if self.rt_spatial not in ("bilinear", "nearest", "nearest1"):
            raise ValueError(f"rt_spatial must be 'bilinear'|'nearest'|"
                             f"'nearest1', got {self.rt_spatial!r}")
        if self.rt_dtype not in ("auto", "float32", "bfloat16"):
            raise ValueError(f"rt_dtype must be 'auto'|'float32'|'bfloat16', "
                             f"got {self.rt_dtype!r}")
        if self.rt_ew_dtype not in ("auto", "float32", "bfloat16"):
            raise ValueError(f"rt_ew_dtype must be 'auto'|'float32'|"
                             f"'bfloat16', got {self.rt_ew_dtype!r}")
        if self.noise_mode not in ("fresh", "pool"):
            raise ValueError(f"noise_mode must be 'fresh'|'pool', got "
                             f"{self.noise_mode!r}")
        if self.rt_occlusion not in ("off", "snap", "edge"):
            raise ValueError(f"rt_occlusion must be 'off'|'snap'|'edge', got "
                             f"{self.rt_occlusion!r}")
        if self.num_agents < 1 or self.num_beams < 2:
            raise ValueError("need num_agents >= 1 and num_beams >= 2")
        if self.ego_idx < 0 or self.ego_idx >= self.num_agents:
            raise ValueError(f"ego_idx {self.ego_idx} out of range for "
                             f"{self.num_agents} agents")
        if self.speed_controller is not None and not callable(self.speed_controller):
            raise ValueError("speed_controller must be callable (or None for "
                             "the reference PID)")

    @property
    def jdtype(self):
        return jnp.dtype(self.dtype)

    @property
    def rt_jdtype(self):
        """Resolved range-texture storage dtype (see rt_dtype)."""
        if self.rt_dtype == "auto":
            return jnp.bfloat16 if self.jdtype == jnp.float32 else self.jdtype
        return jnp.dtype(self.rt_dtype)

    @property
    def angle_increment(self) -> float:
        return self.fov / (self.num_beams - 1)

    @property
    def rt_eff_occlusion(self) -> str:
        """Occlusion mode actually in effect: the edge/snap machinery lives
        in the linear per-tap pipeline; spectral interpolation ignores it."""
        return self.rt_occlusion if self.scan_interp == "linear" else "off"

    @property
    def rt_channels(self) -> int:
        """Texture channels per theta bin: [R | e w (edge mode) | gx gy
        (rt_grad)], concatenated along the row so ONE contiguous row gather
        fetches everything."""
        return (1 + (2 if self.rt_eff_occlusion == "edge" else 0)
                + (2 if self.rt_grad else 0))
