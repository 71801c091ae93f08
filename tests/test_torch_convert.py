"""The committed CIFAR-10 flagship checkpoint (JAX npz tree) through
``jax_variables_to_torch`` into the port's model: every tensor lands, and
every InducedNormConv's effective (soft-normalised) kernel equals the JAX
package's at rtol 1e-6.

The JAX side of that comparison runs in float64: at 32x32 the sigma of a
conv is a dot over 524,288 terms, which XLA's CPU backend sums sequentially
in float32 with a relative error near 5e-4, while the port's float32 sum is
within 1e-6 of the float64 value."""
import os

import jax
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.layers import LogitTransform as JLogit
from implicit_normalizing_flows_tpu.layers.lipschitz import \
    InducedNormConv as JConv
from implicit_normalizing_flows_tpu.models import ImplicitFlow as JFlow
from implicit_normalizing_flows_tpu.training.checkpoints import \
    load_npz_tree as jax_load_npz_tree
from implicit_normalizing_flows_torch.layers import InducedNormConv, LogitTransform
from implicit_normalizing_flows_torch.models import ImplicitFlow
from implicit_normalizing_flows_torch.training import (jax_variables_to_torch,
                                                       load_npz_tree)

CKPT = os.path.join(os.path.dirname(__file__), "..", "experiments",
                    "cifar10_long_r4", "bench_ckpt.npz")
FLAGSHIP = dict(n_blocks=[2, 2, 2], intermediate_dim=512, actnorm=True,
                coeff=0.9, vnorms="2222", n_dist="poisson", kernels="3-1-3",
                preact=True, sn_atol=1e-3, sn_rtol=1e-3)


def flagship_torch(batch=1):
    return ImplicitFlow((batch, 3, 32, 32), init_layer=LogitTransform(0.05),
                        factor_out=False, fc_end=False, device="cpu", **FLAGSHIP)


def flagship_jax(batch=1):
    """The JAX package's flagship (``__graft_entry__._build`` arguments)."""
    return JFlow((batch, 3, 32, 32), init_layer=JLogit(0.05), factor_out=False,
                 n_lipschitz_iters=None, n_power_series=None, fc_end=False,
                 n_exact_terms=10, activation_fn="swish", neumann_grad=True,
                 grad_in_forward=False, first_resblock=True, **FLAGSHIP)


@pytest.fixture(scope="module")
def ckpt():
    return load_npz_tree(CKPT)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield prefix, tree


def test_npz_reader_matches_jax_reader(ckpt):
    ref = jax_load_npz_tree(CKPT)
    a, b = dict(_leaves(ckpt)), dict(_leaves(ref))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=str(k))


def test_checkpoint_round_trips_into_the_port(ckpt):
    sd = jax_variables_to_torch(ckpt["params"], ckpt["state"], compact_f16=True)
    model = flagship_torch()
    model.load_state_dict(sd, strict=True)  # every parameter and buffer covered
    got = model.state_dict()
    assert got.keys() == sd.keys()
    for k, t in sd.items():
        assert t.dtype == torch.float32, k
        torch.testing.assert_close(got[k], t, rtol=0, atol=0)
    # every numeric leaf of the tree is a tensor of the port, same values
    n = 0
    for path, leaf in list(_leaves(ckpt["params"])) + list(_leaves(ckpt["state"])):
        if path[-1] in ("initialized", "last_n_samples", "last_firmom",
                        "last_secmom", "solver_diag"):
            continue
        name = ".".join(path)
        if name not in sd:  # a net's per-layer state sits under .layers.
            for net in ("nnet_x", "nnet_z"):
                name = name.replace(f".{net}.", f".{net}.layers.")
        np.testing.assert_array_equal(
            got[name].numpy(), np.asarray(leaf, np.float32), err_msg=name)
        n += 1
    assert n == len(sd)


def test_effective_weights_match_jax(ckpt):
    cast = lambda t: jax.tree.map(
        lambda a: np.asarray(a, np.float32) if np.asarray(a).dtype == np.float16
        else np.asarray(a), t)
    params, state = cast(ckpt["params"]), cast(ckpt["state"])
    model = flagship_torch()
    model.load_state_dict(jax_variables_to_torch(params, state), strict=True)
    jmodel = flagship_jax()
    checked = 0
    for name, mod in model.named_modules():
        if not isinstance(mod, InducedNormConv):
            continue
        # transforms.<s>.<j>.<net>.layers.<i>
        _, s, j, net, _, i = name.split(".")
        s, j, i = int(s), int(j), int(i)
        jconv = jmodel.transforms[s].chain[j].__dict__[net].items[i]
        assert isinstance(jconv, JConv)
        jv = {"params": params["transforms"][s][j][net]["layers"][i],
              "state": state["transforms"][s][j][net][i]}
        with jax.enable_x64(True):
            jv64 = jax.tree.map(lambda a: jax.numpy.asarray(a, jax.numpy.float64), jv)
            ref = np.asarray(jconv.effective_weight(jv64))
        got = mod.effective_weight().detach().numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0, err_msg=name)
        checked += 1
    assert checked == 36  # 6 blocks x 2 nets x 3 convs
