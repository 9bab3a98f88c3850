from .features import candidate_features, tri_indices  # noqa: F401
from .scorer import mlp_apply, neural_score_fn, load_params, save_params  # noqa: F401
from .labels import solve_subproblem_admm, exact_improvement, exact_score_fn  # noqa: F401
