"""Configuration for the solver stack (the dataclasses of sypha_tpu/config.py).

Field names, types and defaults are those of the JAX package, so the two
packages solve the same problem with the same settings.  Each default was
tuned on the TPU; the reasons, with their TPU measurements, are in the
comments of ``sypha_tpu/config.py`` and have not been re-measured on the
GPU.  ``BnbOptions`` and ``SolverConfig`` are carried over for the branch
and bound and the interfaces that later slices of the port add.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class IpmOptions:
    """Parameters of the Mehrotra predictor-corrector loop."""

    # iteration cap; step damping eta, with eta_k = max(eta, 1 - mu_k) if adaptive
    max_iter: int = 60
    eta: float = 0.95
    adaptive_eta: bool = True
    # convergence: relative duality gap AND relative primal/dual feasibility,
    # or mu below mu_tol_hard while feasible
    tol_gap: float = 1e-8
    tol_feas: float = 1e-8
    mu_tol_hard: float = 1e-12
    # clip on the scaling D^2 = x / s
    d2_min: float = 1e-30
    d2_max: float = 1e30
    # Newton-system strategy: "dense" (f32 factor of the normal matrix as the
    # preconditioner of an f64 PCG), "cg" (matrix-free Jacobi CG with the
    # adaptive tolerance schedule below) or "auto" (cg above 2048 rows)
    linear_solver: str = "dense"
    # CG strategy: tol_k = max(cg_tol_final, cg_tol_initial * cg_tol_decay^k)
    cg_max_iter: int = 500
    cg_tol_initial: float = 1e-2
    cg_tol_final: float = 1e-8
    cg_tol_decay: float = 0.5
    # dense strategy: factor dtype and the ridge added to the equilibrated
    # matrix (None = 2e-6 for float32, 1e-12 for float64)
    factor_dtype: str = "float32"
    factor_ridge: float | None = None
    # leaf size of the block-recursive Cholesky inverse
    chol_leaf_size: int = 64
    # PCG stopping: relative residual and step cap (the batched PCG runs
    # until every lane meets the tolerance, so the cap bounds the batch)
    newton_tol: float = 1e-10
    newton_max_steps: int = 16
    # centering exponent: sigma = (mu_aff / mu) ** sigma_pow
    sigma_pow: int = 3
    # Gondzio centrality correctors per iteration (extra solves on the factor)
    max_correctors: int = 0
    # refresh the f32 factor only every k-th iteration
    factor_refresh_every: int = 1
    # complementarity target window of the correctors
    corrector_beta_min: float = 0.1
    corrector_beta_max: float = 10.0
    # divergence guard
    mu_max: float = 1e32
    # GAP_STALLED after gap_stall_window iterations that improve the gap by
    # less than gap_stall_min_improv (fraction); 0 disables
    gap_stall_window: int = 0
    gap_stall_min_improv: float = 0.01

    def replace(self, **kw) -> "IpmOptions":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class CgOptions:
    """Parameters of the conjugate-gradient normal-equations path."""

    max_cg_iter: int = 500
    tol_initial: float = 1e-2
    tol_final: float = 1e-8
    tol_decay_rate: float = 0.5

    def replace(self, **kw) -> "CgOptions":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class BnbOptions:
    """Branch and bound driver settings (meanings in sypha_tpu/config.py)."""

    max_nodes: int = 100000
    node_batch: int = 64
    warm_start_nodes: bool = False
    gap_stall_branch_iters: int = 5
    gap_stall_min_improv_pct: float = 1.0
    integrality_tol: float = 1e-6
    heuristic_every_n_nodes: int = 1
    log_interval_sec: float = 5.0
    hard_time_limit_sec: float = 0.0
    gap_stagnation_window: int = 50
    auto_fallback_lp: bool = True
    cuts_enabled: bool = True
    cut_rounds_root: int = 5
    max_cuts_per_round: int = 50
    var_selection: str = "most_fractional"
    int_heuristics: str = "nearest_integer_fixing,dual_guided_cover_repair"
    strong_branch_depth: int = 0
    strong_branch_cands: int = 8
    checkpoint_path: str = ""
    checkpoint_interval_sec: float = 60.0
    iter_chunk: int = 8
    iter_chunk_target_sec: float = 3.0
    precompile: bool = True
    mesh_devices: int = 0
    tree_cut_nodes_per_round: int = 2
    tree_cut_max_rounds: int = 200
    lagrangian_samples: int = 600
    lagrangian_budget_sec: float = 15.0
    lagrangian_min_gap: float = 2.0
    core_time_frac: float = 0.45
    core_time_cap_sec: float = 60.0
    endgame_frontier: int = 256
    endgame_stall_sec: float = 20.0
    core_rounds: int = 3
    root_time_frac: float = 0.5
    bucket_cols_floor: int = 0
    core_min_active: int = 1000
    core_mult: int = 6
    cut_skip_gap: float = 10.0
    compact_resolve: bool = True
    compact_frac: float = 0.5
    exact_closure: bool = True
    async_closure: bool = True
    closure_use_cuts: bool = False
    node_operator: str = "auto"
    node_ell_density: float = 0.05

    def replace(self, **kw) -> "BnbOptions":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class SolverConfig:
    """Top-level configuration: environment and all subsystem options."""

    verbosity: int = 5
    time_limit_sec: float = 0.0  # 0 = unlimited
    seed: int = 0
    # linear solver strategy: auto | dense | cg
    linear_solver: str = "auto"
    disable_bnb: bool = False
    show_solution: bool = False
    preprocess_time_limit_sec: float = 5.0
    preprocess_column_strategies: str = "single_column_dominance,two_column_dominance"
    ipm: IpmOptions = IpmOptions()
    cg: CgOptions = CgOptions()
    bnb: BnbOptions = BnbOptions()

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)
