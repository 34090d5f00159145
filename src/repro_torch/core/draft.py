"""Device-resident draft models for speculative decoding (the JAX
package's ``core/draft.py``).

Offloaded decode streams the whole layer stack over the link once per
generated token.  Speculative decoding amortizes that: a small draft
model whose weights live entirely on the device proposes ``k`` cheap
tokens, then the streamed target scores all ``k+1`` positions in one
ragged decode step, so one trip through the stack buys up to ``k+1``
tokens.  Greedy accept/reject keeps the emitted stream equal to
non-speculative greedy decode for any proposal stream; the draft's
quality moves only the acceptance length.

``ResidentDraft`` is the real draft: a registry architecture run through
the port's whole-model ``prefill``/``decode_step`` (the resident
engine's path, so on the card its attention goes through
``flash_attention`` and ``decode_attention``), with its own device KV
cache slaved to the target's slot positions.  Rejected rows are never
truncated: they sit past the live position, masked by decode attention
(``kv_pos <= pos``), and the next proposal pass overwrites them.

``accept_length``/``accepted_tokens`` are the accept rule both engines
share.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.models.transformer import to_device

__all__ = ["ResidentDraft", "accept_length", "accepted_tokens"]


def accept_length(draft: Sequence[int], target: Sequence[int]) -> int:
    """Greedy accept rule: the number of leading proposals that match the
    target's per-position greedy choices.  ``target[i]`` is the target's
    argmax at the position whose input was ``draft[i-1]`` (``target[0]``'s
    input is the current token)."""
    a = 0
    k = len(draft)
    while a < k and int(draft[a]) == int(target[a]):
        a += 1
    return a


def accepted_tokens(draft: Sequence[int], target: Sequence[int]):
    """The tokens one verify pass emits: the ``a`` accepted proposals plus
    the target's bonus token at the first divergence (or after the last
    proposal), ``target[:a+1]`` — what ``a+1`` sequential greedy steps
    would emit."""
    a = accept_length(draft, target)
    return [int(t) for t in target[:a + 1]]


class ResidentDraft:
    """A fully device-resident greedy draft model.

    It holds its parameters (``init_params(cfg, seed)``, f32) and its
    bf16 KV cache on ``device`` (CUDA unless the caller asks for the
    CPU) and is slaved to the engine's slot state: ``prefill_slot``/
    ``prefill_batch`` admit prompts, ``propose(tokens, pos, k)`` runs
    ``k`` ragged decode steps from the engine's per-slot positions."""

    def __init__(self, cfg: ModelConfig, *, b_max: int, max_len: int,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.b_max = b_max
        self.max_len = max_len
        self.dev = resolve_device(device)
        self.model = build_model(cfg)
        self.params = to_device(self.model.init(seed), self.dev)
        self.caches = self.model.init_cache(b_max, max_len, self.dev)

    @property
    def nbytes(self) -> int:
        """Device bytes of the draft's parameters and caches."""
        return sum(t.numel() * t.element_size()
                   for tree in (self.params, self.caches)
                   for t in _leaves(tree))

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(
            tokens, np.int32)).to(self.dev)

    # ---- admission -------------------------------------------------------
    def prefill_slot(self, slot: int, prompt: np.ndarray) -> None:
        """Admit one prompt into ``slot`` (the serving path): its
        ``max_len`` slab (prompt rows, zeros past them) replaces the
        slot's rows."""
        _, cache1 = self.model.prefill(
            self.params, {"tokens": self._tokens(prompt)[None]}, self.max_len)
        for grp in ("pat", "rem"):
            ax = 1 if grp == "pat" else 0      # 'pat' leaves lead periods
            for big, one in zip(self.caches[grp], cache1[grp]):
                for name, leaf in big.items():
                    leaf.select(ax, slot).copy_(one[name].select(ax, 0))

    def prefill_batch(self, tokens: np.ndarray) -> None:
        """Admit a full uniform batch (the ``PipelinedLM`` path);
        ``tokens`` is ``(b_max, s)``."""
        if tokens.shape[0] != self.b_max:
            raise ValueError(f"prefill_batch takes {self.b_max} rows, got "
                             f"{tokens.shape}")
        _, caches = self.model.prefill(
            self.params, {"tokens": self._tokens(tokens)}, self.max_len)
        for big, one in zip(_leaves(self.caches), _leaves(caches)):
            big.copy_(one)

    # ---- proposal --------------------------------------------------------
    def propose(self, tokens, pos, k: int) -> np.ndarray:
        """Run ``k`` greedy draft steps from the engine's state:
        ``tokens`` (b_max,) are the last emitted tokens (in no cache yet),
        ``pos`` (b_max,) the target's per-slot positions; step ``t``
        feeds the previous token at ``pos + t``.  The running tokens stay
        on the device; the proposals cross to the host once.  Returns
        ``(b_max, k)`` int32."""
        cur = self._tokens(np.asarray(tokens).reshape(-1))[:, None]
        base = self._tokens(np.asarray(pos).reshape(-1))
        out = []
        for t in range(int(k)):
            nt, self.caches = self.model.decode_step(
                self.params, {"token": cur, "pos": base + t}, self.caches)
            out.append(nt)
            cur = nt[:, None]
        return torch.stack(out, dim=1).cpu().numpy().astype(np.int32)


def _leaves(tree):
    """Tensors of a params or cache tree, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]
