"""TLFre for sparse-group lasso — the PyTorch/CUDA port of ``repro.core``.

Public surface:
  Problem, Plan, SGLSession   problem spec, run config, ``.path`` / ``.cv``
                              / ``.refine`` / ``.stability``
                              (``Plan(engine='legacy')``: the paper's
                              per-lambda driver)
  RefineResult                warm two-stage grid refinement
  GroupSpec                   group bookkeeping (ragged + padded views)
  lambda_max_sgl, dual_scaling_sgl, group_shrink_roots,
  lambda1_max, lambda2_max
  SQUARED, LOGISTIC, get_loss the smooth data-fit terms
  shrink, proj_binf, dual_decompose, sgl_primal_objective,
  sgl_dual_objective          the decomposition operators (Lemma 3 /
                              Remark 2) and the objectives of (3)
  DualBall, estimate_dual_ball, gap_safe_ball,
  tlfre_screen, screen_stats, dpc_screen, estimate_dual_ball_nn,
  solve_sgl, solve_nn_lasso   the single-lambda API
  sgl_path, nn_lasso_path, rejection_ratios_sgl
                              the per-lambda driver (``engine='legacy'``)
                              or a shim over ``SGLSession.path``
  sgl_cv, nn_lasso_cv         legacy shims over ``SGLSession.cv``
  tlfre_screen_grid, fista_sgl, sgl_path_batched
  gap_safe_screen_grid, gap_safe_grid_radii(_loss)
                              the Gap-Safe grid rules (beyond the paper)
  fista_sgl_graphed
                              the FISTA block replayed as a CUDA graph (card)
  lambda_max_nn, dual_scaling_nn, dpc_screen_grid, fista_nn_lasso,
  nn_lasso_path_batched       the DPC nonnegative Lasso
  kfold_indices, sgl_fold_paths, nn_fold_paths, CVResult, FoldState
                              fold-batched cross-validation (``init=``:
                              warm fold states)
  stability_selection, subsample_masks, StabilityResult
                              stability selection (Meinshausen-Buhlmann)
"""
from .groups import (GroupSpec, broadcast_to_features, group_max_abs,
                     group_norms, group_sum, pad_groups, resolve_device)
from .fenchel import (dual_decompose, group_inf_norms, proj_binf,
                      sgl_dual_feasible, sgl_dual_objective,
                      sgl_feasibility_margin, sgl_penalty,
                      sgl_primal_objective, shrink, weighted_l1)
from .losses import (LOGISTIC, SQUARED, LogisticLoss, Loss, SquaredLoss,
                     get_loss)
from .lambda_max import (dual_scaling_sgl, group_shrink_roots, lambda1_max,
                         lambda2_max, lambda_max_sgl)
from .estimation import (DualBall, estimate_dual_ball, gap_safe_ball,
                         normal_vector_sgl, project_out_normal)
from .screening import (ScreenResult, gap_safe_grid_radii,
                        gap_safe_grid_radii_loss, gap_safe_screen_grid,
                        gap_safe_screen_grid_folds, grid_ball_geometry,
                        grid_ball_geometry_folds, screen_stats,
                        sup_shrink_norm, tlfre_screen, tlfre_screen_grid,
                        tlfre_screen_grid_folds)
from .dpc import (dpc_screen, dpc_screen_grid, dpc_screen_grid_folds,
                  dual_scaling_nn, estimate_dual_ball_nn,
                  gap_safe_screen_grid_nn, lambda_max_nn, nn_dual_feasible,
                  nn_dual_objective, nn_primal_objective, normal_vector_nn)
from .prox import nn_lasso_prox, sgl_prox
from .linalg import (column_norms, group_frobenius_norms,
                     group_spectral_norms, spectral_norm)
from .solver import (SolveResult, fista_nn_lasso, fista_sgl,
                     fista_sgl_graphed, solve_nn_lasso, solve_sgl)
from .path import (PathResult, default_lambda_grid, nn_lasso_path,
                   rejection_ratios_sgl, sgl_path)
from .path_engine import (EngineStats, nn_lasso_path_batched,
                          sgl_path_batched)
from .cv import (CVResult, FoldState, StabilityResult, kfold_indices,
                 nn_fold_paths, nn_lasso_cv, per_fold_centering, sgl_cv,
                 sgl_fold_paths, stability_selection, subsample_masks)
from .problem import Plan, Problem, as_group_spec, warn_legacy_entry_point
from .session import RefineResult, SGLSession

__all__ = [n for n in dir() if not n.startswith("_")]
