"""Linear probe: encoder features and a warm-started logistic-regression sweep
over C.

Counterpart of ``flyp_tpu/training/linear_probe.py`` (the reference's
``linear_lbfgs.py``).  The features come from the image tower once (B3 on
the card) through ``evaluation/features.py::get_features`` and its cache
under ``cfg.cache_dir``; the sweep keeps the C whose fit scores best on
the evaluation features.

The JAX package fits with scikit-learn's ``LogisticRegression(warm_start=
True)``, which the card's machine does not have.  :class:`LogisticRegression`
below is that estimator's recipe for the ``lbfgs`` solver, written in
torch: the objective is the mean log loss plus ``0.5 ||W||^2 / (C n)``
(the intercept not penalised), binomial with one coefficient row for two
classes and multinomial for more; ``scipy.optimize.minimize(method=
"L-BFGS-B")`` with scikit-learn's options drives it, and each loss and
gradient is computed in torch on the features' device, in their dtype.
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import torch

from flyp_tpu_torch.data.registry import get_dataset_class
from flyp_tpu_torch.data.transforms import eval_transform, train_transform
from flyp_tpu_torch.evaluation.classifier import Classifier
from flyp_tpu_torch.evaluation.features import get_features
from flyp_tpu_torch.models.head import ClassificationHead
from flyp_tpu_torch.parallel.multihost import is_primary


_TOL = 1e-4  # LogisticRegression's default tol, L-BFGS-B's gtol


class LogisticRegression:
    """L2-penalised logistic regression on the ``lbfgs`` solver, as
    scikit-learn 1.9's ``LogisticRegression(warm_start=True)`` fits it
    (``_logistic_regression_path``, ``LinearModelLoss``): ``coef_`` ``(1,
    D)`` and ``intercept_`` ``(1,)`` for two classes, ``(K, D)`` and
    ``(K,)`` for K > 2, in the features' dtype.  Each fit starts from the
    previous one's solution."""

    def __init__(self, C: float = 1.0, max_iter: int = 100):
        self.C, self.max_iter = C, max_iter

    def _loss_grad(self, w, X, target, binary: bool, l2: float):
        """scikit-learn's ``LinearModelLoss.loss_gradient`` at the float64
        parameter vector ``w`` (the multinomial's ``(K, D + 1)`` raveled in
        Fortran order): the objective and its gradient, both float64."""
        n, d = X.shape
        if binary:
            weights, intercept = w[:-1], w[-1:]
        else:
            coef = w.reshape((d + 1, -1)).T  # reshape((K, -1), order="F")
            weights, intercept = coef[:, :-1], coef[:, -1]
        w_t = torch.as_tensor(weights, dtype=X.dtype, device=X.device)
        b_t = torch.as_tensor(intercept, dtype=X.dtype, device=X.device)
        if binary:
            raw = X @ w_t + b_t
            # HalfBinomialLoss: log(1 + exp(raw)) - y raw; its gradient sigmoid(raw) - y.
            pointwise = torch.nn.functional.softplus(raw) - target * raw
            grad_pointwise = torch.sigmoid(raw) - target
        else:
            raw = X @ w_t.T + b_t
            # HalfMultinomialLoss: logsumexp(raw) - raw[y]; its gradient softmax(raw) - onehot(y).
            pointwise = torch.logsumexp(raw, dim=1) - raw.gather(1, target[:, None])[:, 0]
            grad_pointwise = torch.softmax(raw, dim=1)
            grad_pointwise[torch.arange(n, device=X.device), target] -= 1
        grad_pointwise = grad_pointwise / n
        if binary:
            parts = [X.T @ grad_pointwise, grad_pointwise.sum()[None]]
        else:
            parts = [grad_pointwise.T @ X, grad_pointwise.sum(0)[:, None]]
        loss = pointwise.sum() / n
        host = torch.cat([loss[None].double(), *(p.reshape(-1).double() for p in parts)]).cpu().numpy()
        penalty = 0.5 * l2 * float(np.sum(weights * weights))
        if binary:
            grad = np.empty(d + 1)
            grad[:d] = host[1:d + 1] + l2 * weights
            grad[d] = host[d + 1]
        else:
            k = weights.shape[0]
            grad = np.empty((k, d + 1))
            grad[:, :d] = host[1:1 + k * d].reshape(k, d) + l2 * weights
            grad[:, d] = host[1 + k * d:]
            grad = grad.T.reshape(-1)  # ravel(order="F")
        return float(host[0]) + penalty, grad

    def fit(self, X: torch.Tensor, y: np.ndarray) -> "LogisticRegression":
        from scipy import optimize

        y = np.asarray(y)
        self.classes_ = np.unique(y)
        k = len(self.classes_)
        if k < 2:
            raise ValueError(f"This solver needs samples of at least 2 classes in the data, but the data contains "
                             f"only one class: {self.classes_[0]!r}")
        n, d = X.shape
        binary = k == 2
        encoded = np.searchsorted(self.classes_, y)
        if binary:
            target = torch.as_tensor(encoded == 1, dtype=X.dtype, device=X.device)
            w0 = np.zeros(d + 1)
        else:
            target = torch.as_tensor(encoded, dtype=torch.long, device=X.device)
            w0 = np.zeros((k, d + 1))
        if getattr(self, "coef_", None) is not None:
            w0 = np.concatenate([self.coef_, self.intercept_[:, None]], axis=1).astype(np.float64)
            w0 = w0[0] if binary else w0
        if not binary:
            w0 = w0.T.reshape(-1)  # ravel(order="F")
        l2 = 1.0 / (self.C * n)
        res = optimize.minimize(self._loss_grad, w0, method="L-BFGS-B", jac=True, args=(X, target, binary, l2),
                                options={"maxiter": self.max_iter, "maxls": 50, "gtol": _TOL,
                                         "ftol": 64 * np.finfo(float).eps})
        dtype = np.float32 if X.dtype == torch.float32 else np.float64
        if binary:
            w = res.x.astype(dtype)
            self.coef_, self.intercept_ = w[None, :-1], w[-1:]
        else:
            w = res.x.reshape((d + 1, k)).T.astype(dtype)
            self.coef_, self.intercept_ = w[:, :-1], w[:, -1]
        self.n_iter_ = res.nit
        return self

    def decision_function(self, X: torch.Tensor) -> torch.Tensor:
        coef = torch.as_tensor(self.coef_, device=X.device)
        scores = X @ coef.T + torch.as_tensor(self.intercept_, device=X.device)
        return scores[:, 0] if scores.shape[1] == 1 else scores

    def predict(self, X: torch.Tensor) -> np.ndarray:
        scores = self.decision_function(X)
        index = (scores > 0).long() if scores.dim() == 1 else scores.argmax(1)
        return self.classes_[index.cpu().numpy()]


def log_reg_warm_start_sweep(
    train_features,
    train_labels,
    test_features,
    test_labels,
    num_cs: int = 100,
    start_c: float = -1,
    end_c: float = 2,
    max_iter: int = 200,
    device="cuda",
):
    """Warm-started L-BFGS logistic regression over a log-C grid: the fit
    with the best test accuracy, ``{"acc", "coef", "intercept", "c",
    "i"}``.  The features are moved to ``device`` in their own dtype."""
    # float32 features stay float32, anything else becomes float64 (scikit-learn's check_array).
    dtype = torch.float32 if np.asarray(train_features).dtype == np.float32 else torch.float64
    X = torch.as_tensor(np.asarray(train_features), device=device).to(dtype)
    X_test = torch.as_tensor(np.asarray(test_features), device=device).to(dtype)
    test_labels = np.asarray(test_labels)
    cs = np.logspace(start_c, end_c, num_cs)
    clf = LogisticRegression(max_iter=max_iter)
    best = {"acc": -1.0}
    for i, c in enumerate(cs):
        clf.C = c
        clf.fit(X, train_labels)
        acc = float((clf.predict(X_test) == test_labels).mean())
        if acc > best["acc"]:
            best = {"acc": acc, "coef": copy.deepcopy(clf.coef_), "intercept": copy.deepcopy(clf.intercept_),
                    "c": float(c), "i": i}
    return best


def linear_probe(cfg, logger, model=None, num_cs: int = 100) -> dict:
    """Features of ``cfg.train_dataset``'s train split and of the first
    evaluation dataset, then the sweep on the model's device; with
    ``cfg.cache_dir`` the best fit goes to ``best_probe_{run}.npz`` and
    ``.json`` there.  ``model`` defaults to ``build_clip_model(cfg,
    device=cfg.device)``."""
    if cfg.train_dataset is None:
        raise AssertionError("Please provide a training dataset.")
    logger.info("Linear Probe")
    if model is None:
        from flyp_tpu_torch.models.factory import build_clip_model

        model = build_clip_model(cfg, device=cfg.device)
    image_size = model.config.vision.image_size
    head = ClassificationHead.zeros(1, model.config.embed_dim).to(model.device)
    clf = Classifier(model, head, batch_size=cfg.batch_size)

    train_ds = get_dataset_class(cfg.train_dataset)(
        preprocess=train_transform(image_size), location=cfg.data_location,
        batch_size=cfg.batch_size, num_workers=cfg.workers,
    )
    # The probe fits on the whole train set's features: no sharding by process.
    if getattr(getattr(train_ds, "train_loader", None), "shard_by_process", False):
        train_ds.train_loader.shard_by_process = False
    cache = cfg.cache_dir
    train = get_features(clf, train_ds, split="train", cache_dir=cache)

    eval_ds = get_dataset_class(cfg.eval_datasets[0])(
        preprocess=eval_transform(image_size), location=cfg.data_location,
        batch_size=cfg.batch_size, num_workers=cfg.workers,
    )
    test = get_features(clf, eval_ds, split="val", cache_dir=cache)

    best = log_reg_warm_start_sweep(train["features"], train["labels"], test["features"], test["labels"],
                                    num_cs=num_cs, device=model.device)
    logger.info(f"Best i {best['i']} best c : {best['c']} best acc : {best['acc']}")

    if cache and is_primary():  # one writer: every process fits the same
        os.makedirs(cache, exist_ok=True)
        np.savez(os.path.join(cache, f"best_probe_{cfg.run}.npz"), coef=best["coef"], intercept=best["intercept"])
        with open(os.path.join(cache, f"best_probe_{cfg.run}.json"), "w") as f:
            json.dump({"acc": best["acc"], "c": best["c"], "i": best["i"]}, f)
    return best
