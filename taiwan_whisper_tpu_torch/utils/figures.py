"""Paper-style figures (port of taiwan_whisper_tpu/utils/figures.py;
reference: utils/drawings/figure1.py — params-vs-MER scatter panels;
figure3.py — data-remaining-vs-threshold curves per filtering method).
matplotlib is optional: each panel raises without it."""

from __future__ import annotations

from typing import Dict, Optional, Sequence


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception as e:  # pragma: no cover
        raise RuntimeError("figures require matplotlib") from e
    return plt


def params_vs_mer_scatter(
    points: Sequence[Dict],
    output_path: str,
    *,
    title: str = "Model size vs MER",
    xlabel: str = "Parameters (M)",
    ylabel: str = "MER (%)",
):
    """points: [{"name", "params_m", "mer", ("group")}] -> scatter PNG/PDF."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    groups: Dict[Optional[str], list] = {}
    for p in points:
        groups.setdefault(p.get("group"), []).append(p)
    for group, pts in groups.items():
        ax.scatter(
            [p["params_m"] for p in pts],
            [p["mer"] for p in pts],
            label=group or None, s=48,
        )
        for p in pts:
            ax.annotate(p["name"], (p["params_m"], p["mer"]),
                        textcoords="offset points", xytext=(4, 4), fontsize=8)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    if any(g for g in groups):
        ax.legend()
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(output_path, dpi=150)
    plt.close(fig)
    return output_path


def filter_threshold_curves(
    curves: Dict[str, Sequence[Dict]],
    output_path: str,
    *,
    title: str = "Data Remaining Percentage with Different Filtering Methods",
    xlabel: str = "Threshold α",
    ylabel: str = "Data Remaining Percentage (%)",
):
    """figure3 variant: one line per filtering method (e.g. MER / PER /
    ngram+PER), each point {"threshold", "remaining_pct"}; x-axis reversed
    (1.0 -> 0.2) like the reference (utils/drawings/figure3.py)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for method, pts in curves.items():
        xs = [p["threshold"] for p in pts]
        ys = [p["remaining_pct"] for p in pts]
        ax.plot(xs, ys, label=method, linewidth=2.5, marker="x", markersize=8)
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    if curves:
        xs_all = [p["threshold"] for pts in curves.values() for p in pts]
        ax.set_xlim(max(xs_all), min(xs_all))  # reversed axis
    ax.set_ylim(0, 100)
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(output_path, dpi=150)
    plt.close(fig)
    return output_path


def params_vs_mer_panels(
    panels: Sequence[Dict],
    output_path: str,
    *,
    highlight: str = "Ours",
):
    """figure1 variant: side-by-side in-domain / out-of-domain scatter panels,
    the highlighted model drawn larger + labeled bold
    (utils/drawings/figure1.py). panels: [{"title", "points": [{"name",
    "params_m", "mer"}]}]."""
    plt = _plt()
    fig, axs = plt.subplots(1, len(panels), figsize=(5.2 * len(panels), 4.6),
                            squeeze=False)
    for ax, panel in zip(axs[0], panels):
        for p in panel["points"]:
            ours = highlight in p["name"]
            ax.scatter(p["params_m"], p["mer"],
                       color="red" if ours else "tab:blue",
                       s=100 if ours else 50, zorder=2)
            ax.annotate(p["name"], (p["params_m"], p["mer"]),
                        textcoords="offset points", xytext=(0, 7),
                        ha="center", fontsize=10,
                        weight="bold" if ours else "normal")
        ax.set_title(panel["title"], fontsize=13)
        ax.set_xlabel("Model Parameters (in millions)")
        ax.set_ylabel("Mix Error Rate (%)")
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(output_path, dpi=150)
    plt.close(fig)
    return output_path
