"""Parameter analysis: clustering, heatmaps and PCA of learned emissions.

The port's copy of ``tehmm_tpu/analysis.py``: plain numpy on the host, with
scipy and matplotlib imported only by the functions that use them.

Rebuild of the reference's parameterAnalysis.py (SURVEY.md §2a:
hierarchical clustering + heatmap/PCA plotting of learned emission
distributions via scipy.cluster + matplotlib; backs teHmmView graphics).

All functions return data structures; plotting writes files only when a
path is given (headless matplotlib 'Agg').
"""

from __future__ import annotations

import numpy as np


def emission_feature_matrix(log_em: np.ndarray) -> np.ndarray:
    """[S, T, V] log table -> [S, T*V] probability-space feature rows
    (missing/pad columns carry probability mass 1 / 0 structurally and
    are harmless for distances)."""
    S = log_em.shape[0]
    probs = np.exp(np.asarray(log_em, dtype=np.float64))
    return probs.reshape(S, -1)


def hierarchical_cluster_states(
    log_em: np.ndarray, method: str = "average"
) -> dict:
    """Agglomerative clustering of states by emission distance
    (reference: parameterAnalysis hierarchical clustering).

    Returns {"linkage": Z, "order": leaf order} — Z is scipy's linkage
    matrix.
    """
    from scipy.cluster import hierarchy
    from scipy.spatial.distance import pdist

    feats = emission_feature_matrix(log_em)
    if len(feats) < 2:
        return {"linkage": np.zeros((0, 4)), "order": [0]}
    dists = pdist(feats, metric="euclidean")
    Z = hierarchy.linkage(dists, method=method)
    order = hierarchy.leaves_list(Z).tolist()
    return {"linkage": Z, "order": order}


def pca_states(log_em: np.ndarray, n_components: int = 2) -> np.ndarray:
    """[S, n_components] PCA projection of the emission features."""
    feats = emission_feature_matrix(log_em)
    centered = feats - feats.mean(axis=0, keepdims=True)
    _u, s, vt = np.linalg.svd(centered, full_matrices=False)
    k = min(n_components, vt.shape[0])
    return centered @ vt[:k].T


def plot_emission_heatmap(
    log_em: np.ndarray,
    state_names: list[str],
    track_names: list[str],
    out_path: str,
    cluster: bool = True,
) -> None:
    """Heatmap of emission probabilities, states optionally reordered by
    hierarchical clustering (reference: teHmmView graphics)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    feats = emission_feature_matrix(log_em)
    order = list(range(len(state_names)))
    if cluster and len(state_names) > 2:
        order = hierarchical_cluster_states(log_em)["order"]
    fig, ax = plt.subplots(
        figsize=(max(6, feats.shape[1] * 0.25),
                 max(3, len(order) * 0.35))
    )
    im = ax.imshow(feats[order], aspect="auto", cmap="viridis",
                   vmin=0.0, vmax=1.0)
    ax.set_yticks(range(len(order)))
    ax.set_yticklabels([state_names[i] for i in order])
    S, T, V = np.asarray(log_em).shape
    ax.set_xticks([t * V + V // 2 for t in range(T)])
    ax.set_xticklabels(track_names, rotation=45, ha="right")
    for t in range(1, T):
        ax.axvline(t * V - 0.5, color="white", lw=0.8)
    fig.colorbar(im, ax=ax, label="emission probability")
    ax.set_title("per-state emission distributions")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_state_pca(
    log_em: np.ndarray,
    state_names: list[str],
    out_path: str,
) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xy = pca_states(log_em, 2)
    fig, ax = plt.subplots(figsize=(6, 5))
    ax.scatter(xy[:, 0], xy[:, 1])
    for name, (x, y) in zip(state_names, xy):
        ax.annotate(name, (x, y), fontsize=8,
                    xytext=(3, 3), textcoords="offset points")
    ax.set_xlabel("PC1")
    ax.set_ylabel("PC2")
    ax.set_title("states in emission space (PCA)")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_transition_graph(
    log_trans: np.ndarray,
    state_names: list[str],
    out_path: str,
    min_prob: float = 0.01,
) -> None:
    """Transition matrix heatmap (reference: teHmmView --trans graphics)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    trans = np.exp(np.asarray(log_trans, dtype=np.float64))
    fig, ax = plt.subplots(
        figsize=(max(4, len(state_names) * 0.5),) * 2
    )
    im = ax.imshow(trans, cmap="magma", vmin=0.0, vmax=1.0)
    ax.set_xticks(range(len(state_names)))
    ax.set_xticklabels(state_names, rotation=90)
    ax.set_yticks(range(len(state_names)))
    ax.set_yticklabels(state_names)
    for i in range(trans.shape[0]):
        for j in range(trans.shape[1]):
            if trans[i, j] >= min_prob:
                ax.text(j, i, f"{trans[i, j]:.2f}", ha="center",
                        va="center", fontsize=6,
                        color="white" if trans[i, j] < 0.5 else "black")
    fig.colorbar(im, ax=ax, label="P(from row to col)")
    ax.set_title("transition probabilities")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
