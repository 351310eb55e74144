"""The time embedding at the shipped frequencies, the port against the JAX
package on the CPU.

With 26 linear frequencies (1 to 2^25, every shipped training YAML but
train_synthetic_small) t*f*pi lies past 2^22 for most times, where the
float32 rounding of the argument alone decides the feature: the frequency
table has to carry XLA's bits. `xla_linspace` is held to `jnp.linspace`
bit for bit, the features to 1e-6, and one motion-basis forward at the
kubric config's widths to 2e-5. The JAX side runs inside `jax.jit`, as its
train step and batched evaluator run it: an eager `jnp.linspace` compiles
alone with start and stop as arguments, and XLA:CPU then contracts its
multiply-add, which moves the last bit of some frequencies. For a single
time (a train step's deformation) XLA rounds the argument as f * (t * pi),
for several as t * (f * pi): both are held.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodygs_tpu.models import motion as JM
from rodygs_tpu_torch import convert
from rodygs_tpu_torch.models import motion as TM

FEATURE_TOL, BASIS_TOL = 1e-6, 2e-5


def _times(kind):
    if kind == "frames":
        return np.arange(24, dtype=np.float32) / np.float32(23)
    if kind == "one":        # a train step's deformation takes one time
        return np.float32(0.42)
    return np.random.default_rng(9).uniform(0, 1, 64).astype(np.float32)


@pytest.mark.parametrize("start,stop,num", [
    (1.0, 2.0 ** 25, 26), (0.0, 25.0, 26), (0.0, 9.0, 10), (1.0, 512.0, 10),
    (1.0, 2.0 ** 14, 15), (0.0, 5.0, 6), (-3.0, 7.5, 33), (2.0, 2.0, 1)])
def test_xla_linspace_bits(start, stop, num):
    want = np.asarray(jax.jit(
        lambda z: jnp.linspace(start, stop, num) + z)(jnp.float32(0)))
    got = TM.xla_linspace(start, stop, num)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("multires,log_sampling", [(26, False), (10, True)])
@pytest.mark.parametrize("times", ["frames", "random", "one"])
def test_embed_time_matches(multires, log_sampling, times):
    t = _times(times)
    want = np.asarray(jax.jit(
        lambda x: JM.embed_time(x, multires, log_sampling))(jnp.asarray(t)))
    got = TM.embed_time(torch.tensor(t), multires, log_sampling).numpy()
    assert got.shape == want.shape == t.shape + (2 * multires + 1,)
    np.testing.assert_allclose(got, want, rtol=0, atol=FEATURE_TOL)


def test_motion_basis_at_kubric_widths():
    cfg = JM.MotionNetConfig(netwidth=128, num_basis=16, t_emb_multires=26)
    jparams = JM.init_motion_params(jax.random.key(4), cfg)
    tparams = convert.net_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    t = _times("frames")
    want = np.asarray(jax.jit(lambda p, x: JM.motion_basis(p, cfg, x))(
        jparams, jnp.asarray(t)))
    got = TM.motion_basis(tparams, TM.MotionNetConfig(*cfg), t).numpy()
    assert got.shape == want.shape == (24, 16, 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=BASIS_TOL)
