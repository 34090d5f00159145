"""The port's training loss against the JAX package's: the MoE, MLA, SSM
and encoder-decoder families at ``scaled_down`` (b 2, s 32), on the same
weights and batch: the loss within 1e-5 relative (the MoE load-balance
term included) and every gradient leaf within 1e-4 x that leaf's max
|g|.  mamba2 (the SSD mixer, ``ssd_chunked`` over the chunk loop), jamba
(SSM, attention, MoE), llama4-scout and deepseek-v3 (MoE; MLA through
``mla_ring_attention``), whisper (the encoder's remat, the decoder's
cross attention over ``enc_embeds``).  The scaled MoE configs are
dropless (``capacity_factor`` = E); llama4 and deepseek again at
``capacity_factor`` 1.0, where the capacity drops routed pairs and the
gradient must flow only through the kept ones, as in the reference.
"""
import pytest

torch = pytest.importorskip("torch")

from train_cases import (assert_grads_close, batch, configs, jax_loss_grads,
                         jax_params, port_loss_grads, port_params)


def _check(arch, **overrides):
    jc, pc = configs(arch, **overrides)
    params = jax_params(jc)
    b = batch(jc)
    jl, jg = jax_loss_grads(jc, params, b)
    pl, pg = port_loss_grads(pc, port_params(params), b)
    assert abs(pl - jl) <= 1e-5 * abs(jl), (pl, jl)
    assert_grads_close(jg, pg)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b",
                                  "llama4-scout-17b-a16e",
                                  "deepseek-v3-671b", "whisper-base"])
def test_loss_and_grads_match_reference(arch):
    _check(arch)


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e",
                                  "deepseek-v3-671b"])
def test_moe_capacity_drops_match_reference(arch):
    from repro_torch.models import moe
    jc, pc = configs(arch, capacity_factor=1.0)
    T, k, E = 2 * 32, pc.moe.top_k, pc.moe.num_experts
    capacity = int(pc.moe.capacity_factor * T * k / E) + 1
    assert capacity < T * k          # some pair can overflow
    # the batch's routing at layer 0 does overflow an expert
    drops = []
    real = moe.moe_ffn_union

    def spy(x, w, ids, params, cap):
        _, slot, valid = moe._dispatch_indices(ids, E, cap)
        drops.append(int((~valid).sum()))
        return real(x, w, ids, params, cap)
    moe.moe_ffn_union = spy
    try:
        _check(arch, capacity_factor=1.0)
    finally:
        moe.moe_ffn_union = real
    assert sum(drops) > 0, drops
