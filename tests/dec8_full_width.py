"""The int8 decode levers' teacher-forced agreement at the flagship's
full width, tell_tpu against the port, on the CPU (a script, not a test:
it takes some minutes).

    JAX_PLATFORMS=cpu python tests/dec8_full_width.py

CaptionerConfig() with tell_tpu's init_captioner (seed 0) carried across
with the bridge, four requests of random features from a numpy seed
(articles of 512, 300, 120 and 40 real tokens, two faces and 20 objects
each); the port's greedy ids (fp path, every step) are the targets, and
each package's predict_forced under dec8 and under dec8_sm scores its
top-1 against them over the live tokens (tell_tpu under TELL_TPU_DEC8 /
TELL_TPU_DEC8_SM, jitted). Prints each lever's two agreements and how
often the two packages' predictions are equal.
"""
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tell_tpu.config import CaptionerConfig as JConfig  # noqa: E402
from tell_tpu.models.captioner import init_captioner  # noqa: E402
from tell_tpu.models.captioner import predict_forced as j_forced  # noqa
from tell_tpu_torch.bridge import to_torch  # noqa: E402
from tell_tpu_torch.config import CaptionerConfig  # noqa: E402
from tell_tpu_torch.models.captioner import (generate,  # noqa: E402
                                             predict_forced)

LEVERS = (("dec8", "TELL_TPU_DEC8"), ("dec8_sm", "TELL_TPU_DEC8_SM"))


def main() -> int:
    torch.set_num_threads(os.cpu_count() or 1)
    t = time.time()
    jcfg, cfg = JConfig(), CaptionerConfig()
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: init_captioner(k, jcfg))(jax.random.PRNGKey(0)))
    B = 4
    rng = np.random.default_rng(1)
    spec = {c.name: (c.max_len, c.kv_dim) for c in jcfg.decoder.contexts}
    S = spec["article"][0]
    mask = np.zeros((B, S), bool)
    for b, n in enumerate((512, 300, 120, 40)):
        mask[b, n:] = True
    faces = rng.normal(size=(B,) + spec["faces"]).astype(np.float32)
    faces[:, 2:] = np.nan
    objs = rng.normal(size=(B,) + spec["obj"]).astype(np.float32)
    objs[:, 20:] = np.nan
    batch = {"image_grid": rng.normal(size=(B,) + spec["image"]
                                      ).astype(np.float32),
             "article_hiddens": rng.normal(size=(
                 B, S, jcfg.num_bert_layers, spec["article"][1])
             ).astype(np.float32) * 0.5,
             "article_mask": mask, "face_embeds": faces,
             "obj_embeds": objs}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tparams = to_torch(params, "cpu")
    with torch.inference_mode():
        ref = generate(tparams, cfg, tb, early_stop=False)["token_ids"]
    target = ref[:, 1:]
    live = target != cfg.decoder.pad_id
    for lever, env in LEVERS:
        with torch.inference_mode():
            port = predict_forced(tparams, cfg, tb, ref, **{lever: True})
        os.environ[env] = "1"
        try:
            jax_pred = np.asarray(jax.jit(
                lambda p, b, ids: j_forced(p, jcfg, b, ids))(
                    params, batch, jnp.asarray(ref.numpy())))
        finally:
            os.environ.pop(env)
        a_port = float((port == target)[live].float().mean())
        a_jax = float((jax_pred == target.numpy())[live.numpy()].mean())
        same = float((jax_pred == port.numpy()).mean())
        print(f"{lever}: port {a_port:.4f}, tell_tpu {a_jax:.4f} over "
              f"{int(live.sum())} tokens; the two packages' predictions "
              f"equal at {same:.4f} of the steps ({time.time() - t:.0f} s)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
