"""Evaluation and training steps: (dequantise ->) flow -> bits/dim or NLL
and solver telemetry, and for training the gradient, the optimizer step,
the power iteration and the EMA.

Counterparts of the JAX package's ``make_image_step(model, None,
train=False)`` and ``make_image_step(model, optimizer, train=True)``
(``training/loops.py:45-102,214-226,246-391``) for the image density task
without padding and with ``accum_steps=1``, and of
``make_density_train_step`` / ``make_density_eval_step``
(``loops.py:111-205``) for the flat (tabular) models without learned
p-orders.
"""
from __future__ import annotations

import math

import torch


def standard_normal_logprob(z):
    """Per-example sum log N(z; 0, I)."""
    logZ = -0.5 * math.log(2 * math.pi)
    return torch.sum(logZ - z ** 2 / 2, dim=tuple(range(1, z.ndim)))


def dequantize(x_u8, noise, nvals=256):
    """(u8 + u) / nvals with the uniform noise ``u`` given
    (``loops.py:214-226``)."""
    return (x_u8.float() + noise) / nvals


def estimator_stats(model):
    """Pool the blocks' estimator moments of the last training forward
    (``loops.py:78-102``)."""
    blocks = model.implicit_blocks()
    if not blocks:
        return {}
    return {"est_firmom": torch.cat([b.last_firmom for b in blocks]).mean(),
            "est_secmom": torch.cat([b.last_secmom for b in blocks]).mean()}


def solver_stats(model):
    """Pool the blocks' 5-slot telemetry (``loops.py:45-75``): means of
    nstep and converged fractions, max of prot_break and rms_over_tol."""
    diags = [b.solver_diag for b in model.implicit_blocks()]
    if not diags:
        return {}
    d = torch.stack([t.to(diags[0].device) for t in diags])
    return {"broyden_nstep": d[:, 0].mean(), "broyden_converged": d[:, 1].mean(),
            "broyden_prot_break": d[:, 2].max(),
            "broyden_rms_over_tol": d[:, 3].max(),
            "broyden_converged_3eps": d[:, 4].mean()}


def make_image_eval_step(model, *, im_dim=3, imagesize=32, nvals=256):
    """Returns ``step(x_u8, draws) -> metrics`` with ``bpd_vec`` (B,),
    ``bpd``, ``logpz``, ``delta_logp``, ``z`` and the pooled solver stats.
    ``draws`` (``ops.logdet.Draws``) supplies the dequantisation noise, the
    probes and the roulette draws. The images are moved to the model's
    device."""
    dim = imagesize * imagesize * im_dim
    device = next(model.parameters()).device

    @torch.no_grad()
    def step(x_u8, draws):
        x_u8 = torch.as_tensor(x_u8, device=device)
        x = dequantize(x_u8, draws.uniform(x_u8.shape, device), nvals)
        zeros = torch.zeros(x.shape[0], device=x.device)
        z, delta_logp = model(x, zeros, draws)
        logpz = standard_normal_logprob(z)
        logpx = logpz - delta_logp - math.log(nvals) * dim
        bpd_vec = -logpx / dim / math.log(2)
        m = {"bpd_vec": bpd_vec, "bpd": bpd_vec.mean(), "logpz": logpz.mean(),
             "delta_logp": (-delta_logp).mean(), "z": z}
        m.update(solver_stats(model))
        return m

    return step


class TrainStep:
    """One training step per call: loss -> gradients -> ``optimizer``
    (global-norm clip and the update) -> ``update_lipschitz`` -> EMA. The
    model's parameters, the optimizer state ``opt_state`` and the EMA shadow
    ``ema`` (both ``{name: tensor}`` over ``named_parameters``) are updated
    in place. Subclasses define :meth:`loss`."""

    def __init__(self, model, optimizer, *, ema_decay=0.999, n_lipschitz_iters=None):
        from .ema import ema_init

        self.model, self.optimizer = model, optimizer
        self.ema_decay, self.n_lipschitz_iters = ema_decay, n_lipschitz_iters
        self.device = next(model.parameters()).device
        self.params = dict(model.named_parameters())
        self.opt_state = optimizer.init(self.params)
        self.ema = ema_init(self.params)

    def loss(self, x, draws, *args):
        """(loss, metrics) with the autograd graph."""
        raise NotImplementedError

    def grads(self, x, draws, *args):
        """(loss, metrics, {name: gradient}); a parameter the loss does not
        reach gets zeros."""
        loss, metrics = self.loss(x, draws, *args)
        names = list(self.params)
        gs = torch.autograd.grad(loss, [self.params[k] for k in names],
                                 allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(self.params[k]))
                 for k, g in zip(names, gs)}
        return loss.detach(), metrics, grads

    def __call__(self, x, draws, *args):
        from .ema import ema_apply
        from .optimizers import global_norm

        loss, metrics, grads = self.grads(x, draws, *args)
        metrics["loss"] = loss
        metrics["grad_norm"] = global_norm(grads)
        self.opt_state = self.optimizer.update(self.params, grads, self.opt_state)
        self.model.update_lipschitz(self.n_lipschitz_iters)
        ema_apply(self.ema, self.params, self.ema_decay)
        metrics.update(solver_stats(self.model))
        metrics.update(estimator_stats(self.model))
        return metrics


class ImageTrainStep(TrainStep):
    """One image density training step per call (``loops.py:268-391``).
    Built by :func:`make_image_train_step`."""

    def __init__(self, model, optimizer, *, ema_decay=0.999,
                 n_lipschitz_iters=None, im_dim=3, imagesize=32, nvals=256):
        super().__init__(model, optimizer, ema_decay=ema_decay,
                         n_lipschitz_iters=n_lipschitz_iters)
        self.nvals, self.dim = nvals, imagesize * imagesize * im_dim

    def loss(self, x_u8, draws):
        """(loss, metrics) with the autograd graph: mean bits/dim of the
        training estimator (``loss_fn``, ``loops.py:268-336``)."""
        x_u8 = torch.as_tensor(x_u8, device=self.device)
        x = dequantize(x_u8, draws.uniform(x_u8.shape, self.device), self.nvals)
        zeros = torch.zeros(x.shape[0], device=x.device)
        z, delta_logp = self.model(x, zeros, draws, train=True)
        logpz = standard_normal_logprob(z)
        logpx = logpz - delta_logp - math.log(self.nvals) * self.dim
        bpd = torch.mean(-logpx / self.dim / math.log(2))
        return bpd, {"bpd": bpd.detach(), "logpz": logpz.detach().mean(),
                     "delta_logp": (-delta_logp).detach().mean()}


def make_image_train_step(model, optimizer, *, ema_decay=0.999,
                          n_lipschitz_iters=None, im_dim=3, imagesize=32,
                          nvals=256) -> ImageTrainStep:
    """Returns ``step(x_u8, draws) -> metrics`` (loss, bpd, logpz,
    delta_logp, grad_norm, the pooled solver stats and the estimator
    moments): loss -> gradients -> ``optimizer`` (``training.optimizers``)
    -> ``update_lipschitz`` -> EMA. The images are moved to the model's
    device; ``draws`` supplies the dequantisation noise, probes and
    roulette draws."""
    return ImageTrainStep(model, optimizer, ema_decay=ema_decay,
                          n_lipschitz_iters=n_lipschitz_iters, im_dim=im_dim,
                          imagesize=imagesize, nvals=nvals)


class DensityTrainStep(TrainStep):
    """One flat-model density training step per call
    (``make_density_train_step``, ``loops.py:111-182``): ``step(x, draws,
    beta=1.0)`` with the loss ``-mean(logpz - beta * delta_logp)`` in nats.
    Built by :func:`make_density_train_step`."""

    def loss(self, x, draws, beta=1.0):
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        zeros = torch.zeros(x.shape[0], device=x.device)
        z, delta_logp = self.model(x, zeros, draws, train=True)
        logpz = standard_normal_logprob(z)
        loss = -torch.mean(logpz - beta * delta_logp)
        return loss, {"logpz": logpz.detach().mean(),
                      "delta_logp": (-delta_logp).detach().mean()}


def make_density_train_step(model, optimizer, *, n_lipschitz_iters=None,
                            ema_decay=0.999) -> DensityTrainStep:
    """Returns ``step(x, draws, beta=1.0) -> metrics`` (loss, logpz,
    delta_logp, grad_norm, the pooled solver stats and the estimator
    moments) for a flat model such as ``build_tabular_model``'s: the rows
    ``x`` (B, D) are moved to the model's device; ``draws`` supplies the
    probes and roulette draws."""
    return DensityTrainStep(model, optimizer, ema_decay=ema_decay,
                            n_lipschitz_iters=n_lipschitz_iters)


def make_density_eval_step(model):
    """Returns ``step(x, draws) -> metrics`` (``make_density_eval_step``,
    ``loops.py:185-205``): ``loss`` the mean NLL in nats, ``nll_vec`` (B,),
    ``logpz``, ``delta_logp``, ``z`` and the pooled solver stats, with the
    blocks' evaluation log-det (the brute force for D <= 10, else the basic
    estimator with the test exact-term budget)."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def step(x, draws):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        z, delta_logp = model(x, torch.zeros(x.shape[0], device=device), draws)
        logpz = standard_normal_logprob(z)
        nll = -(logpz - delta_logp)
        m = {"loss": nll.mean(), "nll_vec": nll, "logpz": logpz.mean(),
             "delta_logp": (-delta_logp).mean(), "z": z}
        m.update(solver_stats(model))
        return m

    return step
