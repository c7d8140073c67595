"""Bayesian neural network demo: uncertainty quantification and active
learning.

Counterpart of ``examples/bayesian_nn_demo.py``: sparse-data regression
with credible intervals (SVI on the true ELBO, learned means and scales),
then the pool points an active learner would label next. The plot is drawn
on Agg into ``plot_dir`` only when matplotlib is present; it is optional
here as in the script.

Run: python3 -m tsu_tpu_torch.examples.bayesian_nn_demo [--device cpu] [--<size> N ...]
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np

from tsu_tpu_torch import BayesianRegressor
from tsu_tpu_torch.config import resolve_device
from tsu_tpu_torch.examples import cli


def main(n_epochs: int = 300, n_test: int = 101, n_predict: int = 200,
         plot_dir: str = "visual_output", device=None) -> dict:
    device = resolve_device(device)
    rng = np.random.default_rng(42)

    # Sparse training data: 7 points of a noisy sinusoid.
    x_train = np.array([-3.0, -2.0, -1.0, 0.0, 1.0, 2.0, 3.0]).reshape(-1, 1)
    y_train = np.sin(x_train) + 0.1 * rng.standard_normal((7, 1))

    print("[1] Training a BayesianRegressor on 7 points (SVI, true ELBO)")
    model = BayesianRegressor(input_dim=1, hidden_dims=[20, 20], prior_std=1.0,
                              temperature=1.0, seed=0, device=device)
    history = model.fit(x_train, y_train, n_epochs=n_epochs, learning_rate=0.01,
                        kl_weight=0.01)
    print(f"    final loss {history['loss_history'][-1]:.4f}")

    # Predict with credible intervals on a dense grid.
    x_test = np.linspace(-5, 5, n_test).reshape(-1, 1)
    mean, lower, upper = model.predict_with_interval(x_test, n_samples=n_predict,
                                                     confidence=0.95)
    in_range = (np.abs(x_test) <= 3).ravel()
    width_in = float(np.mean(upper[in_range] - lower[in_range]))
    width_out = float(np.mean(upper[~in_range] - lower[~in_range]))
    line = ("[2] 95% credible-interval width: "
            f"{width_in:.3f} inside the data, {width_out:.3f} outside "
            f"({width_out / width_in:.1f}x wider where the model is ignorant)")
    print(line)

    # Active learning: ask the model where labels would help most.
    pool = np.linspace(-5, 5, 201).reshape(-1, 1)
    picks = model.select_informative_samples(pool, n_select=5, n_samples=100)
    print("[3] Active-learning picks (highest predictive std):",
          np.round(pool[picks].ravel(), 2))

    figure = None
    if importlib.util.find_spec("matplotlib") is None:
        print("[4] Plot skipped: matplotlib is not installed")
    else:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from tsu_tpu_torch.visualization import plot_predictions_with_uncertainty

        fig = plot_predictions_with_uncertainty(
            x_test.ravel(), mean.ravel(), (upper - lower).ravel() / 4.0,   # ~1 std
            x_train=x_train.ravel(), y_train=y_train.ravel(), show=False)
        os.makedirs(plot_dir, exist_ok=True)
        figure = os.path.join(plot_dir, "bayesian_nn_demo.png")
        fig.savefig(figure, dpi=120)
        plt.close(fig)
        print(f"[4] Saved {figure}")
    return {"final_loss": float(history["loss_history"][-1]), "width_in": width_in,
            "width_out": width_out, "picks": pool[picks].ravel(), "figure": figure,
            "line": line}


if __name__ == "__main__":
    cli(main, __doc__)
