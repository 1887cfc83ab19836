"""Typed TOML configuration, the same schema as ``diffmm_tpu/config.py``.

Four sections (``base``, ``data``, ``hyper``, ``train``) loaded from TOML
with code defaults; the reference's legacy keys map through
``_LEGACY_ALIASES`` so every shipped ``conf/*.toml`` loads to the same values
as under the JAX package. Field meanings are documented there; this copy
keeps the schema and the defaults.

The port reads none of the JAX package's environment knobs
(``DIFFMM_SPMM``, ``DIFFMM_SEGSUM*``): on the card the dense form always
goes through the ``spmm_dual`` kernel and the sparse form through the
``segsum`` kernel, with no other route. The data knobs ``DIFFMM_DATA_ROOT``,
``DIFFMM_FEAT_CACHE`` and ``DIFFMM_SYNTH_MODE`` keep their meaning
(``data/loader.py``).

:func:`check_slice_support` checks the execution knobs' spellings; every
setting of the JAX package's schema runs on one device.
"""

from __future__ import annotations

import ast
import dataclasses
import tomllib
from dataclasses import dataclass, field
from typing import Any


@dataclass
class BaseConfig:
    latdim: int = 64
    topk: int = 20
    gpu: str = "0"
    seed: int = 8888
    denoise_dim: str = "[1024]"
    d_emb_size: int = 10
    cl_method: int = 0
    # auto|xla|pallas in the JAX package; every value takes the hand kernel
    # on the card here (ops/kernels/denoise_mlp.py)
    denoiser_impl: str = "auto"
    denoise_param_dtype: str = "f32"

    def denoise_dims(self) -> list[int]:
        """Hidden widths of the denoiser MLP (reference `Main.py:97`)."""
        if isinstance(self.denoise_dim, str):
            dims = ast.literal_eval(self.denoise_dim)
        else:
            dims = list(self.denoise_dim)
        if not isinstance(dims, list) or not all(isinstance(d, int) for d in dims):
            raise ValueError(f"denoise_dim must parse to a list of ints, got {dims!r}")
        return dims


@dataclass
class DataConfig:
    name: str = "tiktok"
    user_num: int = 0
    item_num: int = 0
    image_feat_dim: int = 0
    text_feat_dim: int = 0
    audio_feat_dim: int = 0
    missing_modalities: str = "zeros"
    synth_svd_rank: int = 0


@dataclass
class HyperConfig:
    modal_cl_temp: float = 0.5
    modal_cl_rate: float = 0.01
    cross_cl_temp: float = 0.2
    cross_cl_rate: float = 0.2
    noise_degree: float = 0.2

    noise_scale: float = 0.1
    noise_min: float = 0.0001
    noise_max: float = 0.02
    steps: int = 5

    sim_weight: float = 0.1
    residual_weight: float = 0.5
    modal_adj_weight: float = 0.2

    sampling_step: int = 0

    knn_topk: int = 10
    use_knn_adj: bool = False


@dataclass
class TrainConfig:
    lr: float = 0.001
    batch: int = 1024
    test_batch: int = 256
    reg: float = 1e-5
    epoch: int = 50
    tstEpoch: int = 1
    gnn_layer: int = 1
    use_lr_scheduler: bool = True
    graph_form: str = "auto"
    dense_budget_gb: float = 0.0
    dense_store: str = "int8"
    train_store: str = "auto"
    rebuild_topk: str = "approx"
    rebuild_compute: str = "f32"
    rebuild_order: str = "identity"
    segsum_compute: str = "f32"
    stack_modal: bool = True
    epoch_scan: int = 1
    donate_buffers: bool = True


@dataclass
class Config:
    base: BaseConfig = field(default_factory=BaseConfig)
    data: DataConfig = field(default_factory=DataConfig)
    hyper: HyperConfig = field(default_factory=HyperConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


# legacy key -> (section-local new key | None to drop)
_LEGACY_ALIASES: dict[str, str | None] = {
    "sampling_steps": "sampling_step",
    "e_loss": "sim_weight",
    "keepRate": None,
    "trans": None,
    "rebuild_k": None,
    "norm": None,
    "sampling_noise": None,
}


def _filter_section(cls: type, raw: dict[str, Any], strict: bool) -> dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    out: dict[str, Any] = {}
    for key, value in raw.items():
        if key in names:
            out[key] = value
            continue
        if key in _LEGACY_ALIASES:
            mapped = _LEGACY_ALIASES[key]
            if mapped is not None and mapped in names and mapped not in raw:
                out[mapped] = value
            continue
        if strict:
            raise ValueError(f"Unknown config key {key!r} for section {cls.__name__}")
    return out


def load_config(path: str, strict: bool = False) -> Config:
    """Load a TOML config, tolerating the reference's legacy keys."""
    with open(path, "rb") as fh:
        raw = tomllib.load(fh)
    return config_from_dict(raw, strict=strict)


def config_from_dict(raw: dict[str, Any], strict: bool = False) -> Config:
    return Config(
        base=BaseConfig(**_filter_section(BaseConfig, raw.get("base", {}), strict)),
        data=DataConfig(**_filter_section(DataConfig, raw.get("data", {}), strict)),
        hyper=HyperConfig(**_filter_section(HyperConfig, raw.get("hyper", {}), strict)),
        train=TrainConfig(**_filter_section(TrainConfig, raw.get("train", {}), strict)),
    )


def resolve_field(config: Config, qual: str) -> tuple[Any, str]:
    """``'hyper.steps'`` / ``'train.lr'`` / bare ``'steps'`` (hyper section
    by default; bare ``'seed'`` maps to base.seed) -> (section object,
    field name)."""
    section, _, key = qual.rpartition(".")
    if not section and key == "seed":
        section = "base"
    obj = getattr(config, section, None) if section else config.hyper
    if obj is None or not hasattr(obj, key):
        raise ValueError(f"unknown config field {qual!r}")
    return obj, key


def cast_field(caster: type, raw: Any) -> Any:
    """Cast an override string to a config field's type, parsing bools."""
    if caster is bool and isinstance(raw, str):
        low = raw.strip().lower()
        if low in ("true", "1", "yes", "on"):
            return True
        if low in ("false", "0", "no", "off"):
            return False
        raise ValueError(f"not a boolean: {raw!r}")
    return caster(raw)


def apply_overrides(config: Config, overrides: list[str]) -> Config:
    """Apply ``'section.key=value'`` strings in order (later wins)."""
    for item in overrides:
        qual, sep, raw = item.partition("=")
        if not sep:
            raise ValueError(f"override must be key=value, got {item!r}")
        obj, key = resolve_field(config, qual)
        setattr(obj, key, cast_field(type(getattr(obj, key)), raw))
    return config


def check_slice_support(config: Config) -> None:
    """Raise ``ValueError`` for a spelling of an execution knob that the
    port does not know; every value the JAX package accepts is ported.

    The knobs: ``base.denoise_param_dtype`` and ``train.rebuild_compute``
    (f32|bf16) and ``train.dense_store`` (int8|bf16|int4); a denoiser of any
    depth, ``hyper.use_knn_adj`` and ``train.donate_buffers`` take any
    value. The other settings' values are checked by the code that reads
    them, as in the JAX package. The CLI's ``--mesh`` and ``--distributed``
    check the mesh against the world size (``cli.py``)."""
    for name, allowed in (
        ("base.denoise_param_dtype", ("f32", "bf16")),
        ("train.rebuild_compute", ("f32", "bf16")),
        ("train.dense_store", ("int8", "bf16", "int4")),
    ):
        section, key = name.split(".")
        value = getattr(getattr(config, section), key)
        if value not in allowed:
            raise ValueError(f"{name} must be {'|'.join(allowed)}, got {value!r}")
