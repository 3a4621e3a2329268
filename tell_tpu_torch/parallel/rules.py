"""tell_tpu's sharding rules as data (counterpart of the rule table of
tell_tpu/parallel/mesh.py): per leaf path, the dim and the axis it is
sharded over. parallel/mesh.py cuts and gathers the params by them, and
comm.ModelAxis reads them to tell a forward which of its leaves are
"model" shards. Nothing here imports the rest of the package.
"""
from __future__ import annotations

import re

# (path regex, spec) — first match wins; a spec names each dim's axis or
# None. Paths look like "decoder/layers/0/attn/image/q_proj/w".
# tell_tpu/parallel/mesh.py:35-62, rule for rule.
_RULES: list[tuple[str, tuple]] = [
    (r".*/attn/[^/]+/(q_proj|k_proj|v_proj)/w$", (None, "model")),
    (r".*/attn/[^/]+/(q_proj|k_proj|v_proj)/b$", ("model",)),
    (r".*/attn/[^/]+/out_proj/w$", ("model", None)),
    (r".*/fc1/(v|w)$", (None, "model")),
    (r".*/fc1/(g|b)$", ("model",)),
    (r".*/fc2/(v|w)$", ("model", None)),
    (r".*/embed/bands/\d+/embed$", ("model", None)),
    (r".*/embed/bands/\d+/proj$", (None, None)),
    (r".*/self_attn/(q|k|v)/w$", (None, "model")),
    (r".*/self_attn/o/w$", ("model", None)),
    (r".*/ffn/(w1|w3)/w$", (None, "model")),
    (r".*/ffn/w2/w$", ("model", None)),
    (r".*/ffn/(w1|w2|w3)$", ("model", None, None)),
    (r".*/ffn/router/w$", ()),
    (r".*tok_embed$", ("model", None)),
    (r".*", ()),
]


def leaf_spec(path: str, shape: tuple[int, ...], mesh_shape: dict
              ) -> tuple:
    """The spec tell_tpu gives the leaf at `path`: the first matching
    rule's, or () (replicated) where the rule names more dims than the
    leaf has or a sharded dim does not divide by its axis."""
    for pattern, spec in _RULES:
        if re.fullmatch(pattern, path):
            if len(spec) > len(shape):
                return ()
            for dim, axis in enumerate(spec):
                if axis is not None and shape[dim] % mesh_shape[axis]:
                    return ()
            return spec
    return ()
