"""Typed config objects for runia-tpu (the PyTorch port's own copy of
``runia_core_tpu/config.py``, which it does not import).

The reference threads an ``omegaconf.DictConfig`` positionally through the
evaluation and postprocessor layers and reads keys with try/AttributeError
fallbacks (reference: runia_core/evaluation/latent_space.py:83-177,
runia_core/inference/postprocessors.py:265-268,377-380). We keep the same
consumed key names but use a small dependency-free attribute-dict so that user
code written against the reference's ``cfg.k_neighbors``-style access works
unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional

__all__ = ["Config", "default_config"]


class Config:
    """Attribute-accessible configuration container.

    Behaves like ``omegaconf.DictConfig`` for the access patterns the reference
    uses: ``cfg.key`` raises AttributeError for missing keys (so downstream
    try/except-defaults keep working), ``key in cfg`` works, and nested dicts
    are wrapped on access.
    """

    def __init__(self, data: Optional[Mapping[str, Any]] = None, **kwargs: Any):
        object.__setattr__(self, "_data", {})
        if data is not None:
            self._data.update(dict(data))
        self._data.update(kwargs)

    # -- mapping protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        data = object.__getattribute__(self, "_data")
        if name in data:
            value = data[name]
            if isinstance(value, dict):
                # Wrap ONCE and store the wrapper back so nested attribute
                # writes persist (cfg.sub.x = 5 must stick, as in omegaconf;
                # a throwaway wrapper would silently discard them).
                value = Config(value)
                data[name] = value
            return value
        raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        if name == "_data":
            object.__setattr__(self, name, value)
        else:
            self._data[name] = value

    def __getitem__(self, name: str) -> Any:
        return getattr(self, name)

    def __setitem__(self, name: str, value: Any) -> None:
        self._data[name] = value

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def get(self, name: str, default: Any = None) -> Any:
        return self._data.get(name, default)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def to_dict(self) -> Dict[str, Any]:
        return {
            k: v.to_dict() if isinstance(v, Config) else v
            for k, v in self._data.items()
        }

    def __repr__(self) -> str:  # pragma: no cover
        return f"Config({self._data!r})"


def default_config(**overrides: Any) -> Config:
    """Config pre-populated with the defaults the reference assumes.

    Key names match the reference exactly (SURVEY.md section 5 "Config / flag
    system"): ``num_classes``, ``k_neighbors``, ``ash_percentile``,
    ``gen_gamma``, ``react_percentile``, ``dice_percentile``,
    ``n_pca_components``, ``ood_datasets``, ``ind_dataset``,
    ``z_score_thresholds``, ``mlflow_experiment_name``.
    """
    cfg = Config(
        num_classes=10,
        k_neighbors=50,
        ash_percentile=85,
        gen_gamma=0.1,
        react_percentile=90,
        dice_percentile=90,
        n_pca_components=(2, 4, 8, 16, 32),
        ood_datasets=(),
        ind_dataset="ind",
        z_score_thresholds=1.645,
        mlflow_experiment_name="runia-tpu",
        mlflow_logging=False,
    )
    for key, value in overrides.items():
        cfg[key] = value
    return cfg
