"""Public model facade: one object binding a ``ModelConfig`` to init,
prefill, decode and its caches (the JAX package's ``models/model.py``,
without training and the dry-run input specs)."""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # ---- parameters -------------------------------------------------------
    def init(self, seed: int):
        """The f32 numpy parameter tree drawn from ``seed``."""
        return T.init_params(self.cfg, seed)

    # ---- compute entry points ---------------------------------------------
    def prefill(self, params, batch, cache_len: int):
        return T.prefill(params, batch, self.cfg, cache_len)

    def decode_step(self, params, batch, caches):
        return T.decode_step(params, batch, caches, self.cfg)

    # ---- caches ------------------------------------------------------------
    def init_cache(self, b: int, cache_len: int, device="cuda",
                   enc_len=None):
        return T.init_cache(self.cfg, b, cache_len, device, enc_len)

    def cache_struct(self, b: int, cache_len: int, enc_len=None):
        return T.cache_struct(self.cfg, b, cache_len, enc_len)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
