"""Anthropometrics: Gaussian priors over body dimensions.

Counterpart of nimblephysics_tpu/biomechanics/anthropometrics.py
(reference: dart/biomechanics/Anthropometrics and
math::MultivariateGaussian): the log-pdf runs in torch on the tensor it
is given, so that the prior joins fitting losses with its gradient; the
CSV and XML parsing and the conditioning stay in numpy.
"""

from __future__ import annotations

import csv
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


class MultivariateGaussian:
    """Reference parity: math::MultivariateGaussian (log-pdf + conditioning)."""

    def __init__(self, names: Sequence[str], mu: np.ndarray, cov: np.ndarray):
        self.names = list(names)
        self.mu = np.asarray(mu, dtype=np.float64)
        self.cov = np.asarray(cov, dtype=np.float64)
        self._prec = np.linalg.inv(self.cov)
        sign, logdet = np.linalg.slogdet(self.cov)
        self._log_norm = -0.5 * (
            len(self.mu) * np.log(2 * np.pi) + logdet
        )

    @staticmethod
    def load_from_csv(
        path: str, columns: Sequence[str], units: float = 1.0
    ) -> "MultivariateGaussian":
        """Fit mean/covariance to named numeric CSV columns * units.

        Reference parity: math::MultivariateGaussian::loadFromCSV
        (MultivariateGaussian.hpp:61) — the loader the reference's
        RajagopalANSURModel uses on the ANSUR II public CSVs with
        units=0.001 (mm -> m). Non-numeric rows are skipped."""
        columns = list(columns)
        rows: List[List[float]] = []
        with open(path, newline="", encoding="utf-8",
                  errors="replace") as f:
            reader = csv.DictReader(f)
            for rec in reader:
                try:
                    rows.append(
                        [float(rec[c]) * units for c in columns]
                    )
                except (KeyError, TypeError, ValueError):
                    continue
        data = np.asarray(rows, dtype=np.float64)
        if data.shape[0] < 2:
            raise ValueError(
                f"no usable rows for columns {columns} in {path}"
            )
        mu = data.mean(axis=0)
        cov = np.cov(data, rowvar=False)
        return MultivariateGaussian(columns, mu, cov)

    # Reference-API alias.
    loadFromCSV = load_from_csv

    def log_pdf(self, x) -> torch.Tensor:
        """log N(x; mu, cov) of a tensor x (d,), on x's device and dtype
        (numpy: float64 on the CPU)."""
        x = torch.as_tensor(x, dtype=torch.float64) if not isinstance(x, torch.Tensor) else x
        d = x - torch.as_tensor(self.mu, dtype=x.dtype, device=x.device)
        prec = torch.as_tensor(self._prec, dtype=x.dtype, device=x.device)
        return self._log_norm - 0.5 * d @ prec @ d

    def condition(self, observed: Dict[str, float]) -> "MultivariateGaussian":
        """Condition the Gaussian on a subset of named values."""
        obs_idx = [self.names.index(k) for k in observed]
        free_idx = [i for i in range(len(self.names)) if i not in obs_idx]
        mu_o = self.mu[obs_idx]
        mu_f = self.mu[free_idx]
        S_ff = self.cov[np.ix_(free_idx, free_idx)]
        S_fo = self.cov[np.ix_(free_idx, obs_idx)]
        S_oo = self.cov[np.ix_(obs_idx, obs_idx)]
        x_o = np.array([observed[self.names[i]] for i in obs_idx])
        K = S_fo @ np.linalg.inv(S_oo)
        mu_new = mu_f + K @ (x_o - mu_o)
        cov_new = S_ff - K @ S_fo.T
        return MultivariateGaussian(
            [self.names[i] for i in free_idx], mu_new, cov_new
        )


class Anthropometrics:
    """Prior over named body dimensions mapped to skeleton body scales.

    Reference parity: biomechanics::Anthropometrics (Anthropometrics.hpp:
    45-95; the python surface's get_anthropometric_log_pdf). Two metric
    kinds:

      * axis metrics (`add_metric`): dim = base_value *
        body_scales[body, axis] — the lightweight programmatic form;
      * marker-pair metrics (`add_pair_metric` / `load_from_file`): the
        reference's AnthroMetric — the distance between two body-fixed
        points at a given whole-body pose, measured on the SCALED
        skeleton (optionally projected on an axis). This is what
        ANSUR_Rajagopal_metrics.xml describes and what conditions the
        ANSUR Gaussian on height/weight.
    """

    def __init__(self):
        self._metrics: List[dict] = []
        self._gauss: Optional[MultivariateGaussian] = None
        self._skeleton = None

    def add_metric(
        self, name: str, body: int, axis: int, base_value: float
    ) -> None:
        """Register `name` as base_value * body_scales[body, axis]."""
        self._metrics.append(
            dict(kind="axis", name=name, body=body, axis=axis,
                 base=base_value)
        )

    def add_pair_metric(
        self, name: str, body_pose, body_a: str, offset_a, body_b: str,
        offset_b, axis=(0.0, 0.0, 0.0),
    ) -> None:
        """Reference: Anthropometrics::addMetric (Anthropometrics.hpp:62)
        — bodies referenced by NAME, resolved against the skeleton at
        measure time (set_skeleton / the `skel` argument)."""
        self._metrics.append(
            dict(kind="pair", name=name,
                 pose=np.asarray(body_pose, dtype=np.float64),
                 body_a=body_a, offset_a=np.asarray(offset_a, np.float64),
                 body_b=body_b, offset_b=np.asarray(offset_b, np.float64),
                 axis=np.asarray(axis, dtype=np.float64))
        )

    @staticmethod
    def load_from_file(path: str) -> "Anthropometrics":
        """Parse a <Metrics> XML (the reference's
        ANSUR_Rajagopal_metrics.xml format: Name, MarkerA/MarkerB with
        BodyNode + Offset, MeasureAlongAxis, BodyPose). Reference:
        Anthropometrics::loadFromFile (Anthropometrics.hpp:50)."""
        root = ET.parse(path).getroot()
        anthro = Anthropometrics()

        def vec(el):
            return np.array([float(x) for x in el.text.split()])

        for mx in root.findall("Metric"):
            ma, mb = mx.find("MarkerA"), mx.find("MarkerB")
            anthro.add_pair_metric(
                mx.find("Name").text.strip(),
                vec(mx.find("BodyPose")),
                ma.find("BodyNode").text.strip(), vec(ma.find("Offset")),
                mb.find("BodyNode").text.strip(), vec(mb.find("Offset")),
                axis=vec(mx.find("MeasureAlongAxis")),
            )
        return anthro

    # Reference-API alias.
    loadFromFile = load_from_file

    def set_skeleton(self, skel) -> None:
        """Bind a skeleton for pair-metric measurement (body names ->
        indices are resolved lazily per skeleton, reference getMarkers)."""
        self._skeleton = skel

    def get_metric_names(self) -> List[str]:
        return [m["name"] for m in self._metrics]

    # Reference-API alias.
    getMetricNames = get_metric_names

    def set_distribution(self, gauss: MultivariateGaussian) -> None:
        """Restrict the metric list to the Gaussian's names (extra
        Gaussian dims like Age/Weightlbs/Heightin stay in the Gaussian —
        condition() them away before evaluating log_pdf)."""
        by_name = {m["name"]: m for m in self._metrics}
        self._metrics = [by_name[n] for n in gauss.names if n in by_name]
        self._gauss = gauss

    def condition(self, observed: Dict[str, float]) -> "Anthropometrics":
        """Reference: Anthropometrics::condition (hpp:77) — condition the
        Gaussian on observed values (e.g. Heightin/Weightlbs) and drop
        those dims."""
        out = Anthropometrics()
        out._metrics = list(self._metrics)
        out._skeleton = self._skeleton
        out.set_distribution(self._gauss.condition(observed))
        return out

    def _measure_stack(self, body_scales, skel):
        from nimblephysics_tpu_torch.biomechanics.scaled_fk import (
            scaled_forward_kinematics,
        )

        def t(x):
            return torch.as_tensor(x, dtype=body_scales.dtype, device=body_scales.device)

        vals = []
        fk_cache: Dict[bytes, torch.Tensor] = {}
        for m in self._metrics:
            if m["kind"] == "axis":
                vals.append(m["base"] * body_scales[m["body"], m["axis"]])
                continue
            if skel is None:
                raise ValueError("pair metrics need a skeleton: set_skeleton() first")
            key = m["pose"].tobytes()
            if key not in fk_cache:
                nq = skel.num_dofs
                pose = np.zeros(nq)
                pose[: min(nq, len(m["pose"]))] = m["pose"][:nq]
                fk_cache[key] = scaled_forward_kinematics(
                    skel, t(pose), body_scales
                )
            T = fk_cache[key]
            ia, ib = skel.body_index(m["body_a"]), skel.body_index(
                m["body_b"]
            )
            pa = T[ia, :3, :3] @ (
                t(m["offset_a"]) * body_scales[ia]
            ) + T[ia, :3, 3]
            pb = T[ib, :3, :3] @ (
                t(m["offset_b"]) * body_scales[ib]
            ) + T[ib, :3, 3]
            d = pa - pb
            if np.any(m["axis"]):
                vals.append(torch.abs(d @ t(m["axis"])))
            else:
                vals.append(torch.sqrt(torch.sum(d * d) + 1e-18))
        return torch.stack(vals)

    def measure(self, skel=None, body_scales=None, device=None) -> Dict[str, torch.Tensor]:
        """Metric name -> value on the (scaled) skeleton. Reference:
        Anthropometrics::measure (hpp:85). body_scales: a tensor (on its
        device), numpy (float64 on `device`) or None, all ones on
        `device`; `device` is the card unless device="cpu"."""
        from nimblephysics_tpu_torch.batched.engine import _resolve_device

        skel = skel if skel is not None else self._skeleton
        if body_scales is None:
            nb = skel.num_bodies if skel is not None else (
                max((m["body"] for m in self._metrics
                     if m["kind"] == "axis"), default=-1) + 1
            )
            body_scales = np.ones((nb, 3))
        if not isinstance(body_scales, torch.Tensor):
            body_scales = torch.as_tensor(body_scales, dtype=torch.float64,
                                          device=_resolve_device(device))
        vals = self._measure_stack(body_scales, skel)
        return {m["name"]: vals[i] for i, m in enumerate(self._metrics)}

    def log_pdf(self, body_scales: torch.Tensor, skel=None) -> torch.Tensor:
        """Gaussian log-density of the measured metrics — differentiable
        in body_scales (feeds MarkerFitter's anthropometric prior)."""
        if self._gauss is None:
            raise ValueError("set_distribution first")
        if len(self._metrics) != len(self._gauss.names):
            raise ValueError(
                "Gaussian has dims with no skeleton metric "
                f"({set(self._gauss.names) - set(self.get_metric_names())}); "
                "condition() on them first (e.g. Age/Weightlbs/Heightin)"
            )
        skel = skel if skel is not None else self._skeleton
        dims = self._measure_stack(body_scales, skel)
        return self._gauss.log_pdf(dims)
