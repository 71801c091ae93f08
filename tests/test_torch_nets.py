"""The port's LipschitzNet (forward and ``conv_forward_data``) against the JAX
package's on the same JAX-initialised weights: idim 16, 3x8x8, preact on and
off. atol 1e-5 on activations (float32 convs summed in another order)."""
import jax
import numpy as np
import pytest
import torch

from implicit_normalizing_flows_tpu.models.implicit_flow import \
    build_conv_net as jax_build_conv_net
from implicit_normalizing_flows_torch.models.implicit_flow import build_conv_net
from implicit_normalizing_flows_torch.training.convert import jax_variables_to_torch


def make_pair(preact, c=3, hw=8, idim=16, seed=1, sn_tol=None):
    """(jax_net, jax_vars, torch_net) with the same weights."""
    first = not preact
    jnet = jax_build_conv_net((c, hw, hw), idim, "3-1-3", 0.9, [2.0] * 3,
                              [2.0] * 3, 3, "swish", preact=preact, dropout=0.0,
                              sn_atol=sn_tol, sn_rtol=sn_tol, learn_p=False,
                              first_resblock=first)
    x0 = jax.numpy.zeros((1, c, hw, hw))
    v = jnet.init(jax.random.PRNGKey(seed), x0)
    tnet = build_conv_net((c, hw, hw), idim, "3-1-3", 0.9, 3, preact, sn_tol,
                          sn_tol, first_resblock=first, device="cpu")
    to_np = lambda t: jax.tree.map(np.asarray, t)
    sd = jax_variables_to_torch({"nnet_x": to_np(v["params"])},
                                {"nnet_x": to_np(v["state"])})
    sd = {k.split(".", 1)[1]: t for k, t in sd.items()}
    tnet.load_state_dict(sd, strict=True)
    return jnet, v, tnet


@pytest.mark.parametrize("preact", [True, False])
def test_lipschitz_net_forward_matches_jax(preact):
    jnet, v, tnet = make_pair(preact)
    x = (np.random.RandomState(0).standard_normal((2, 3, 8, 8)) * 0.5).astype(np.float32)
    ref = np.asarray(jnet.apply(v, jax.numpy.asarray(x)))
    got = tnet(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("preact", [True, False])
def test_conv_forward_data_matches_jax(preact):
    jnet, v, tnet = make_pair(preact)
    ref = jnet.conv_forward_data(v)
    got = tnet.conv_forward_data()
    assert got["preact"] == ref["preact"] == preact
    for k in ("w1", "w2", "w3", "b1", "b2", "b3", "betas"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(ref[k]),
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("n_iterations", [2, None])
def test_update_lipschitz_matches_jax(n_iterations):
    """The power-iteration refresh gives the JAX package's u/v/sigma: a fixed
    budget of 2, and the adaptive atol/rtol 1e-3 loop (cap 200)."""
    jnet, v, tnet = make_pair(True, sn_tol=1e-3)
    # move the weights off the init's settled u/v so the loop has work
    scale = lambda i: 1.0 + 0.3 * np.sin(np.arange(v["params"]["layers"][i]["weight"].size))
    for i, layer in enumerate(tnet.layers):
        if hasattr(layer, "u"):
            w = np.asarray(v["params"]["layers"][i]["weight"])
            w2 = (w.reshape(-1) * scale(i)).reshape(w.shape).astype(np.float32)
            v["params"]["layers"][i]["weight"] = jax.numpy.asarray(w2)
            layer.weight.data = torch.from_numpy(w2)
    v2 = jnet.update_lipschitz(v, n_iterations)
    tnet.update_lipschitz(n_iterations)
    for i, layer in enumerate(tnet.layers):
        if not hasattr(layer, "u"):
            continue
        for name in ("u", "v", "sigma"):
            np.testing.assert_allclose(getattr(layer, name).numpy(),
                                       np.asarray(v2["state"][i][name]),
                                       rtol=1e-4, atol=1e-6, err_msg=f"{i}.{name}")
