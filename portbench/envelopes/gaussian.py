"""``"envelope": {"kind": "gaussian", "center": c, "sigma": s}``: the
Gaussian ``exp(-(t - c)^2 / (2 s^2))``, as BASELINE config 4 (qiskit-dynamics
v0.6.0's perturbative solvers user guide) drives its transmon, with
``c = T / 2`` and ``s = T / 6``."""
import torch


def value(t: torch.Tensor, params: dict) -> torch.Tensor:
    center, sigma = float(params["center"]), float(params["sigma"])
    return torch.exp(-((t - center) ** 2) / (2 * sigma**2))
