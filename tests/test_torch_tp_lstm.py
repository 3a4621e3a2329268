"""The LSTM captioner (expts 1-3) trained tensor-parallel: the rules
shard its adaptive embedding's band tables over "model" (as tell_tpu's
do), so at n_model 2 each of 2 gloo ranks looks up its rows, summed over
"model", and its adaptive softmax gathers each band whole; the LSTM
cells and attention stay whole. tests/test_torch_lstm.py's small config
(weigh_bert on), weights from tell_tpu's init_lstm_captioner: the loss
within 1e-5 relative of tell_tpu's lstm_captioner_loss, the gradients
gathered over "model" within 1e-4 relative L2 per leaf and 1e-5 over
the tree, and the band tables the shards.
"""
import jax
import jax.numpy as jnp
import numpy as np

from tell_tpu.models import lstm_decoder as J
from tell_tpu_torch.parallel import Ranks
from tests import _torch_parallel_workers as W
from tests.test_torch_lstm import LOSS_RTOL, configs, make_batch
from tests.test_torch_tensor_parallel import check_grads


def test_lstm_at_n_model_2_equals_tell_tpu():
    jcfg, pcfg = configs(True)
    jp = jax.jit(J.init_lstm_captioner, static_argnums=1)(
        jax.random.PRNGKey(1), jcfg)
    batch = make_batch(pcfg, seed=2)
    ranks = Ranks(W.tp_loss, 2, (2, "lstm", pcfg,
                                 jax.tree.map(np.asarray, jp), batch),
                  deadline_s=120)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: J.lstm_captioner_loss(p, jcfg, b), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    for out in ranks.join():
        np.testing.assert_allclose(out["loss"], float(jl), rtol=LOSS_RTOL)
        check_grads(out["grads"], jg)
        bands = out["shards"]["decoder"]["embed"]["bands"]
        whole = jp["decoder"]["embed"]["bands"]
        assert [b["embed"].shape[0] * 2 for b in bands] == \
            [w["embed"].shape[0] for w in whole]
