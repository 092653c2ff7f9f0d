"""Typed configuration for models and training.

Same fields and defaults as ``regcn_tpu/config.py`` (``ModelConfig`` and
``TrainConfig``), so a configuration can be handed to either package.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """RE-GCN baseline model configuration (ref:src/rrgcn.py:58-140)."""

    num_ents: int
    num_rels: int  # number of base relations R; the model uses 2R with inverses
    h_dim: int = 200
    n_layers: int = 2
    dropout: float = 0.2
    input_dropout: float = 0.2
    hidden_dropout: float = 0.2
    feat_dropout: float = 0.2
    self_loop: bool = True
    skip_connect: bool = False
    # NOTE: the reference's --layer-norm actually applies F.normalize
    # (L2 row normalisation), not LayerNorm (ref:src/rrgcn.py:151-176).
    layer_norm: bool = True
    entity_prediction: bool = True
    relation_prediction: bool = True
    # decoder (ConvTransE/R) hyperparams (ref:src/decoder.py:11-27)
    decoder_channels: int = 50
    decoder_kernel: int = 3
    # static graph constraint (ref:src/rrgcn.py:101-106,225-247)
    use_static: bool = False
    num_static_rels: int = 0
    num_words: int = 0
    n_bases: int = 100
    static_weight: float = 0.5
    discount: float = 1.0
    angle: float = 10.0
    # numerics
    dtype: str = "float32"  # activations dtype; params always f32

    @property
    def num_rels_total(self) -> int:
        return 2 * self.num_rels


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-3
    weight_decay: float = 1e-5
    grad_norm: float = 1.0
    n_epochs: int = 30
    evaluate_every: int = 1
    task_weight: float = 0.7  # entity vs relation loss (ref:src/main.py:236)
    train_history_len: int = 3
    test_history_len: int = 3
    dilate_len: int = 1  # merge every k consecutive snapshots (ref --dilate-len)
    seed: int = 2023
    # padding buckets: edge counts are rounded up to a multiple of this so
    # the padded shapes (and the kernels' launch shapes) stay few
    edge_bucket: int = 1024
    triple_bucket: int = 512
    rc_bucket: int = 1024  # relation-context incidence pairs


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """A model and its training (the ``model`` and ``train`` fields of
    ``regcn_tpu/config.py:ExperimentConfig``)."""

    model: ModelConfig
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
