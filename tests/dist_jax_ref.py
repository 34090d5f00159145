"""The JAX package's own sharded training loss and its gradients on a
(2, 2) ("data", "model") mesh of four forced host devices, for
``tests/test_torch_distributed.py``.  The forced device count locks at
JAX's first initialisation, so this runs as its own process:

  python tests/dist_jax_ref.py <root> <arch> [<arch> ...]

reads ``<root>/batch_<arch>.npz`` (the batch the port's ranks read),
draws the parameters as the test's parent does (``PRNGKey(0)``, f32),
and writes ``<root>/jax_sharded_<arch>.npz``: ``loss`` and the gradient
leaves ``g<i>`` in ``jax.tree.leaves`` order."""
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=4")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ASSIGNED, scaled_down  # noqa: E402
from repro.launch.sharding import make_dist  # noqa: E402
from repro.models import build_model  # noqa: E402

SCALE = dict(d_model=64, num_heads=4, num_kv_heads=4, vocab_size=256)


def main(root, archs):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    dist = make_dist(mesh)
    for arch in archs:
        m = build_model(scaled_down(ASSIGNED[arch], **SCALE))
        params = m.init(jax.random.PRNGKey(0), jnp.float32)
        z = np.load(os.path.join(root, f"batch_{arch}.npz"))
        batch = {k: jnp.asarray(z[k]) for k in z.files}
        loss, g = jax.jit(jax.value_and_grad(
            lambda p: m.train_loss(p, batch, dist)))(params)
        np.savez(os.path.join(root, f"jax_sharded_{arch}.npz"),
                 loss=np.asarray(loss),
                 **{f"g{i}": np.asarray(x)
                    for i, x in enumerate(jax.tree.leaves(g))})


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
