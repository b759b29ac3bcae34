"""``imdb_mm --fuse 3`` (the MIM expert) at the CLIs' default lr 8e-3: the
first training steps of the JAX package and of the port from the same start
weights on the same synthetic batches, each package's loss a step.

    JAX_PLATFORMS=cpu python tests/_port_mim_lr.py [--steps 6] [--dropout 0]

With ``--dropout 0`` the two runs take the same steps, so their losses
agree to float rounding; with the CLI's dropout (0.3) each package draws its
own masks and only the course of the losses compares. The full-width
expert holds a 512×512×512 fusion tensor (537 MB in fp32): a CPU step takes
about a second in each package.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402  (before jax, as tests/conftest.py does)
import jax  # noqa: E402
import numpy as np  # noqa: E402

from dynmm_tpu.data import imdb as jimdb  # noqa: E402
from dynmm_tpu.models.modality import mmdl as jmmdl  # noqa: E402
from dynmm_tpu.nn import fusions as jfus, mlp as jmlp  # noqa: E402
from dynmm_tpu.train import adapters as jad, supervised as jsup  # noqa: E402
from dynmm_tpu_torch.data.imdb import synthetic_imdb_loaders  # noqa: E402
from dynmm_tpu_torch.models.modality import MMDL, init_model  # noqa: E402
from dynmm_tpu_torch.nn import fusions, mlp  # noqa: E402
from dynmm_tpu_torch.train.adapters import mmdl_adapter  # noqa: E402
from dynmm_tpu_torch.train.supervised import (  # noqa: E402
    SupervisedConfig, SupervisedTrainer, set_dropout_generator)
from dynmm_tpu_torch.utils.weights import flax_variables  # noqa: E402

CFG = dict(task="multilabel", objective="bce_with_logits", lr=8e-3,
           weight_decay=1e-2)


def experts(dropout: float):
    """(JAX, port) MIM experts of ``imdb_mm.build_expert(3)`` with the
    MaxOut MLPs' dropout rate ``dropout``."""
    kw = dict(linear_layer=False, dropout_rate=dropout)
    jm = jmmdl.MMDL(
        [jmlp.MaxOut_MLP(512, first_hidden=512, **kw),
         jmlp.MaxOut_MLP(512, first_hidden=1024, second_hidden=512, **kw)],
        jfus.MultiplicativeInteractions2Modal(output_dim=512),
        jmlp.LinearHead(23))
    tm = MMDL([mlp.MaxOut_MLP(512, 512, 300, **kw),
               mlp.MaxOut_MLP(512, 1024, 4096, 512, **kw)],
              fusions.MultiplicativeInteractions2Modal((512, 512), 512),
              mlp.LinearHead(512, 23))
    return jm, tm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--dropout", type=float, default=0.0)
    args = ap.parse_args(argv)
    jm, tm = experts(args.dropout)
    tm = init_model(tm, seed=0, device="cpu")  # the port CLI's run-0 weights
    variables = {k: v for k, v in flax_variables(tm).items() if v}

    def steps(loader):  # the train split's batches, epoch after epoch
        while True:
            yield from loader

    jt = jsup.SupervisedTrainer(jad.mmdl_adapter(jm),
                                jsup.SupervisedConfig(**CFG))
    state, step = jt.init_state(variables), jt._build_train_step()
    rng, jax_losses = jax.random.PRNGKey(0), []
    jax_train = jimdb.synthetic_imdb_loaders(batch_size=128)[0]
    for _, batch in zip(range(args.steps), steps(jax_train)):
        rng, sub = jax.random.split(rng)
        state, loss, _ = step(state, jt._to_device_batch(batch), sub)
        jax_losses.append(float(loss))
    print("JAX ", np.round(jax_losses, 4).tolist(), flush=True)

    pt = SupervisedTrainer(mmdl_adapter(tm), SupervisedConfig(**CFG),
                           device="cpu")
    pstate = pt.init_state()
    set_dropout_generator(tm, torch.Generator().manual_seed(0))
    port_losses = []
    for _, batch in zip(range(args.steps),
                        steps(synthetic_imdb_loaders(batch_size=128)[0])):
        loss, _ = pt.train_step(pstate, pt.to_device_batch(batch))
        port_losses.append(float(loss))
    print("port", np.round(port_losses, 4).tolist())


if __name__ == "__main__":
    main()
