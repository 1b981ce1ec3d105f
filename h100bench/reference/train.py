"""The first steps of training, followed independently of the program: the
same uint8 batches, labels and mask, each step's generator seeded as the
timed step's was and drawn in its order (JPEG, then the x, y, r, b
decisions, then each hidden layer's dropout), the plain preprocess, the
train-mode forward in f32, the masked cross-entropy, autograd, Adam
(optax's defaults, eps outside the square root) on the exponentially
decayed rate of ``hp``, and the BatchNorm running statistics blended
from each step's batch statistics. Returns, as norms, each step's loss,
each leaf's first gradient, each leaf's change and Adam's second moment
after the steps, and each running statistic's change (none for a model
with no BatchNorm)."""

import torch
import torch.nn.functional as F

from . import augment, nets
from .nets import MOMENTUM
from .params import param_specs, running_statistics, trainable
from .preprocess import preprocess
from .quant import quantizer

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _head_train(h, p, hp, generator, q):
    keep = 1.0 - hp["dropout"]
    for layer in range(hp["hidden_layers"]):
        h = torch.relu(nets.dense(h, p, f"head.hidden{layer}", q))
        if hp["dropout"] > 0:
            u = torch.rand(h.shape, generator=generator, device=h.device)
            h = torch.where(u < keep, h / keep, torch.zeros_like(h))
    return nets.dense(h, p, "head.logits", q)


def steps(weights: dict, config: dict, batches, device, quant=None):
    """``batches``: [(tiles_u8 (N, H, W, 3) numpy, labels (N,), mask (N,),
    generator seed)] a step. Returns {'loss': [float a step],
    'grad1', 'change', 'adam_v': {leaf: norm}, 'running': {running mean
    or variance: norm of its change}}."""
    q = quantizer(quant)
    hp = config["hp"]
    specs = param_specs(config)
    names = trainable(specs)
    p = {n: w.detach().float().clone() for n, w in weights.items()}
    leaves = {n: p[n].requires_grad_() for n in names}
    init = {n: w.detach().clone() for n, w in leaves.items()}
    m = {n: torch.zeros_like(w) for n, w in leaves.items()}
    v = {n: torch.zeros_like(w) for n, w in leaves.items()}
    b1, b2, eps = ADAM_B1, ADAM_B2, ADAM_EPS
    running = {n: p[n].detach().clone() for n in running_statistics(specs)}
    out = {"loss": [], "grad1": {}, "change": {}}
    for t, (tiles, labels, mask, seed) in enumerate(batches):
        gen = torch.Generator(device=device).manual_seed(seed)
        images = torch.as_tensor(tiles).to(device)
        n = images.shape[0]
        if hp["augment"] and "j" in hp["augment"]:
            apply, qual = augment.sample_jpeg(n, gen, device=device)
            images = augment.jpeg_apply(images, apply, qual)
        x = preprocess(images, hp["normalizer"])
        if hp["augment"]:
            x = augment.apply_augment(x, augment.sample_augment(
                n, gen, hp["augment"], device))
        stats = {}
        logits = _head_train(nets.features(x, p, config, train=True, q=q,
                                           stats=stats), p, hp, gen, q)
        labels = torch.as_tensor(labels).to(device).long()
        mask = torch.as_tensor(mask).to(device).float()
        ce = F.cross_entropy(logits, labels.clamp(min=0), reduction="none")
        loss = (ce * mask).sum() / mask.sum().clamp_min(1.0)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        out["loss"].append(float(loss.detach()))
        lr = hp["learning_rate"] * hp["learning_rate_decay"] ** (
            t / hp["learning_rate_decay_steps"])
        with torch.no_grad():
            for (name, w), g in zip(leaves.items(), grads):
                if t == 0:
                    out["grad1"][name] = float(g.norm())
                m[name].mul_(b1).add_(g, alpha=1 - b1)
                v[name].mul_(b2).addcmul_(g, g, value=1 - b2)
                mh = m[name] / (1 - b1 ** (t + 1))
                vh = v[name] / (1 - b2 ** (t + 1))
                w.sub_(lr * mh / (vh.sqrt() + eps))
            for bn, (mean, var) in stats.items():
                for name, batch in ((f"{bn}.running_mean", mean),
                                    (f"{bn}.running_var", var)):
                    running[name].mul_(MOMENTUM).add_(batch,
                                                      alpha=1 - MOMENTUM)
        del grads, logits, x, images, stats
    with torch.no_grad():
        out["change"] = {n: float((w - init[n]).norm())
                         for n, w in leaves.items()}
        out["adam_v"] = {n: float(v[n].norm()) for n in leaves}
        out["running"] = {n: float((r - weights[n].float()).norm())
                          for n, r in running.items()}
    return out
