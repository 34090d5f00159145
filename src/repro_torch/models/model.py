"""Public model facade: one object binding a ``ModelConfig`` to init,
the training loss, prefill, decode, its caches and the dry run's input
structs (the JAX package's ``models/model.py``), each on one device or,
with a mesh ``Dist``, sharded."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.common import Dist


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # ---- parameters -------------------------------------------------------
    def init(self, seed: int, device=None, dtype=torch.bfloat16):
        """The parameter tree drawn from ``seed``: f32 numpy arrays with
        no ``device``; with one, tensors there at ``dtype`` (bf16 by
        default, the reference's training dtype; the SSM scalars stay
        f32)."""
        params = T.init_params(self.cfg, seed)
        if device is None:
            return params
        return T.to_device(params, resolve_device(device), dtype)

    def param_axes(self):
        return T.param_axes(self.cfg)

    # ---- compute entry points ---------------------------------------------
    # ``dist`` as the JAX package's (``Dist.local()`` when None): under a
    # mesh the parameters and caches are DTensors (``launch.sharding``)
    def train_loss(self, params, batch, dist: Dist = None,
                   remat: bool = True):
        return T.train_loss(params, batch, self.cfg, remat, dist)

    def prefill(self, params, batch, dist: Dist = None, cache_len=None):
        """``prefill(params, batch, dist, cache_len)``, the JAX
        signature; ``prefill(params, batch, cache_len)`` on one device."""
        if cache_len is None and not isinstance(dist, Dist):
            dist, cache_len = None, dist
        return T.prefill(params, batch, self.cfg, cache_len, dist)

    def decode_step(self, params, batch, caches, dist: Dist = None):
        return T.decode_step(params, batch, caches, self.cfg, dist)

    # ---- caches ------------------------------------------------------------
    def init_cache(self, b: int, cache_len: int, device="cuda",
                   enc_len=None):
        return T.init_cache(self.cfg, b, cache_len, device, enc_len)

    def cache_struct(self, b: int, cache_len: int, enc_len=None):
        return T.cache_struct(self.cfg, b, cache_len, enc_len)

    # ---- dry-run input structs ----------------------------------------------
    def input_struct(self, shape: ShapeConfig, enc_pad: int = 0):
        """The inputs of a workload shape as meta tensors, the reference's
        structs: int32 tokens and labels, bf16 ``embeds``/``enc_embeds``
        (the frontends' stubs, ``enc_pad`` frames when given); a decode
        step's (b, 1) token and 0-d position."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        meta = lambda sh, dt: torch.empty(sh, dtype=dt, device="meta")
        i32, bf = torch.int32, torch.bfloat16
        if shape.kind == "decode":
            return {"token": meta((b, 1), i32), "pos": meta((), i32)}
        batch = {}
        if shape.kind == "train":
            batch["labels"] = meta((b, s), i32)
        if cfg.frontend == "embeds" and not cfg.enc_dec:
            batch["embeds"] = meta((b, s, cfg.d_model), bf)
        else:
            batch["tokens"] = meta((b, s), i32)
        if cfg.enc_dec:
            batch["enc_embeds"] = meta(
                (b, enc_pad or cfg.encoder_seq_len, cfg.d_model), bf)
        return batch


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
