"""Render docs/media/ppo_learning_curves.png from the committed CSVs.

Usage: python docs/media/plot_curves.py
Reads ppo_curve_seed*.csv (single map) and ppo_multimap_seed*.csv
(7-track multi-map) produced by examples/train_ppo.py --log-csv.
"""

import csv
import glob
import os

import numpy as np
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))

SURFACE = "#fcfcfb"
TEXT = "#0b0b0b"
TEXT2 = "#52514e"
GRID = "#e4e3df"
SERIES = {"single map": "#2a78d6", "multi map (7 tracks)": "#eb6834"}


def load(pattern):
    runs = []
    for f in sorted(glob.glob(os.path.join(HERE, pattern))):
        with open(f) as fh:
            rows = list(csv.DictReader(fh))
        runs.append({k: np.array([float(r[k]) for r in rows])
                     for k in rows[0]})
    return runs


def main():
    data = {"single map": load("ppo_curve_seed*.csv"),
            "multi map (7 tracks)": load("ppo_multimap_seed*.csv")}
    data = {k: v for k, v in data.items() if v}

    fig, axes = plt.subplots(1, 2, figsize=(10, 4.0), facecolor=SURFACE)
    panels = [("speed_mean", "Ego speed (m/s)"),
              ("done_rate", "Episode end rate (crash/finish per step)")]
    for ax, (key, title) in zip(axes, panels):
        ax.set_facecolor(SURFACE)
        for name, runs in data.items():
            c = SERIES[name]
            for r in runs:   # seed replicates: same hue, light
                ax.plot(r["env_steps"] / 1e6, r[key], color=c, lw=0.9,
                        alpha=0.30)
            n = min(len(r[key]) for r in runs)
            mean = np.mean([r[key][:n] for r in runs], axis=0)
            steps = runs[0]["env_steps"][:n] / 1e6
            ax.plot(steps, mean, color=c, lw=2.0, label=name)
            # selective direct label at the line end (speed panel only —
            # both done-rate endpoints are ~0 and the labels would collide)
            if key == "speed_mean":
                ax.annotate(f"{mean[-1]:.2f}", (steps[-1], mean[-1]),
                            textcoords="offset points", xytext=(4, 0),
                            color=TEXT2, fontsize=8, va="center")
        ax.set_title(title, color=TEXT, fontsize=10, loc="left")
        ax.set_xlabel("env steps (millions)", color=TEXT2, fontsize=9)
        ax.tick_params(colors=TEXT2, labelsize=8)
        ax.grid(True, color=GRID, lw=0.6)
        for s in ax.spines.values():
            s.set_color(GRID)
    axes[0].legend(frameon=False, fontsize=9, labelcolor=TEXT)
    fig.suptitle("PPO: 16384 envs × rollout 32, 3 seeds per config "
                 "(thin = seeds, bold = mean)", color=TEXT, fontsize=11,
                 x=0.01, ha="left")
    fig.tight_layout(rect=(0, 0, 1, 0.93))
    out = os.path.join(HERE, "ppo_learning_curves.png")
    fig.savefig(out, dpi=140, facecolor=SURFACE)
    print("wrote", out)
    plot_bitmap_sac()


def plot_bitmap_sac():
    """Render sac_bitmap_curve.png when the bitmap-SAC artifact exists
    (examples/train_sac_bitmap_scale.py --log-csv)."""
    runs = load("sac_bitmap_curve.csv")
    if not runs:
        return
    r = runs[0]
    fig, ax = plt.subplots(figsize=(5.4, 3.6), facecolor=SURFACE)
    ax.set_facecolor(SURFACE)
    ax.plot(r["env_steps"] / 1e3, r["reward_mean"], color="#2a78d6", lw=1.6)
    ax.set_title("Bitmap SAC (64 vmapped PlanningEnvs): mean step reward",
                 color=TEXT, fontsize=10, loc="left")
    ax.set_xlabel("env steps (thousands)", color=TEXT2, fontsize=9)
    ax.tick_params(colors=TEXT2, labelsize=8)
    ax.grid(True, color=GRID, lw=0.6)
    for s in ax.spines.values():
        s.set_color(GRID)
    fig.tight_layout()
    out = os.path.join(HERE, "sac_bitmap_curve.png")
    fig.savefig(out, dpi=140, facecolor=SURFACE)
    print("wrote", out)


if __name__ == "__main__":
    main()
