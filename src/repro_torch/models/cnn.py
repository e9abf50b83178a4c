"""CNN zoo — counterpart of `repro.models.cnn`: the paper's own benchmarks
as LayerSpec lists + an executable small CNN (Sense-sparse conv path).

The LayerSpec lists feed the analytical systolic model (`core.systolic`),
the DRAM-access model (`core.dataflow`) and the cost model
(`launch.cost_model`) — exactly the networks of §VI: AlexNet, VGG-16,
ResNet-50, GoogleNet at ImageNet scale.  `TAB5_SPARSITY` encodes Tab.V's
sparsity ratios per accelerator (zero fractions; a few cells are ambiguous
in the source scan and marked approximate in DESIGN.md §7).

The small CNN runs forward and backward: conv layers with balanced masks
go through the chunked im2col + CUDA balanced GEMM, balanced fc masks
through the balanced GEMM (`engine.plan.plan_smallcnn` decides,
`engine.execute` runs), and autograd carries the gradients back through
the kernels' autograd Functions, the im2col and the plan's value gather
to the dense weights.  `smallcnn_train_step` is the mask-preserving AdamW
step of the paper's prune -> retrain flow (Fig. 5), `smallcnn_train` its
loop over a `engine.plan.TrainPlan` built once per mask set.  The input is
NHWC ``[B, H, W, 3]``, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from ..core.dataflow import LayerSpec

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Tab.V sparsity ratios (zero fraction), per accelerator x network
# keys: (W_CONV, W_FC, IFM_CONV, IFM_FC)
# ---------------------------------------------------------------------------

TAB5_SPARSITY = {
    "swallow": {
        "alexnet": (0.874, 0.811, 0.190, 0.718),
        "vgg16": (0.628, 0.825, 0.395, 0.334),
        "resnet50": (0.469, 0.915, 0.462, 0.220),
        "googlenet": (0.581, 0.907, 0.440, 0.229),
    },
    "spots": {
        "alexnet": (0.568, 0.342, 0.275, 0.497),
        "vgg16": (0.40, 0.40, 0.30, 0.30),        # approx (garbled scan)
        "resnet50": (0.315, 0.40, 0.30, 0.30),    # approx
        "googlenet": (0.251, 0.412, 0.30, 0.30),  # approx
    },
    "sense": {
        # paper §VI-B: CONV kernels pruned to 50% (ImageNet), FC random 80%
        "alexnet": (0.50, 0.80, 0.556, 0.763),
        "vgg16": (0.50, 0.80, 0.492, 0.832),
        "resnet50": (0.50, 0.80, 0.465, 0.705),
        "googlenet": (0.50, 0.80, 0.347, 0.602),
        "vgg16_c10": (0.778, 0.80, 0.471, 0.436),   # VGG-16[y] Cifar-10 (78%)
        "vgg16_c100": (0.778, 0.80, 0.578, 0.631),  # VGG-16[z] Cifar-100
    },
    "fesa": {
        # FESA prunes weights to patterns (balanced), leaves IFMs dense
        "vgg16_c10": (0.825, 0.80, 0.0, 0.0),
        "vgg16_c100": (0.806, 0.80, 0.0, 0.0),
    },
}


def _apply_sparsity(layers: Sequence[LayerSpec], w_conv, w_fc, i_conv, i_fc
                    ) -> list[LayerSpec]:
    out = []
    for l in layers:
        if l.kind == "conv":
            out.append(dataclasses.replace(l, w_sparsity=w_conv,
                                           ifm_sparsity=i_conv))
        else:
            out.append(dataclasses.replace(l, w_sparsity=w_fc,
                                           ifm_sparsity=i_fc))
    return out


def network_layers(name: str, accel: str = "sense") -> list[LayerSpec]:
    """LayerSpec list for one paper benchmark with Tab.V sparsity applied."""
    base = {"alexnet": alexnet_layers, "vgg16": vgg16_layers,
            "vgg16_c10": vgg16_layers, "vgg16_c100": vgg16_layers,
            "resnet50": resnet50_layers, "googlenet": googlenet_layers}
    layers = base[name]()
    table = TAB5_SPARSITY.get(accel, TAB5_SPARSITY["sense"])
    sp = table.get(name) or TAB5_SPARSITY["sense"].get(name) \
        or (0.5, 0.8, 0.45, 0.6)
    return _apply_sparsity(layers, *sp)


# ---------------------------------------------------------------------------
# Layer tables
# ---------------------------------------------------------------------------

def alexnet_layers() -> list[LayerSpec]:
    C = lambda n, hi, ci, co, k, s, p: LayerSpec(
        name=n, kind="conv", h_i=hi, w_i=hi, c_i=ci, c_o=co, h_k=k, w_k=k,
        stride=s, padding=p)
    F = lambda n, ci, co: LayerSpec(name=n, kind="fc", c_i=ci, c_o=co)
    return [
        C("conv1", 227, 3, 96, 11, 4, 0),
        C("conv2", 27, 96, 256, 5, 1, 2),
        C("conv3", 13, 256, 384, 3, 1, 1),
        C("conv4", 13, 384, 384, 3, 1, 1),
        C("conv5", 13, 384, 256, 3, 1, 1),
        F("fc6", 9216, 4096), F("fc7", 4096, 4096), F("fc8", 4096, 1000),
    ]


def vgg16_layers() -> list[LayerSpec]:
    cfg = [(224, 3, 64), (224, 64, 64), (112, 64, 128), (112, 128, 128),
           (56, 128, 256), (56, 256, 256), (56, 256, 256),
           (28, 256, 512), (28, 512, 512), (28, 512, 512),
           (14, 512, 512), (14, 512, 512), (14, 512, 512)]
    layers = [LayerSpec(name=f"conv{i+1}", kind="conv", h_i=hi, w_i=hi,
                        c_i=ci, c_o=co, h_k=3, w_k=3, stride=1, padding=1)
              for i, (hi, ci, co) in enumerate(cfg)]
    layers += [LayerSpec(name="fc14", kind="fc", c_i=25088, c_o=4096),
               LayerSpec(name="fc15", kind="fc", c_i=4096, c_o=4096),
               LayerSpec(name="fc16", kind="fc", c_i=4096, c_o=1000)]
    return layers


def resnet50_layers() -> list[LayerSpec]:
    layers = [LayerSpec(name="conv1", kind="conv", h_i=224, w_i=224, c_i=3,
                        c_o=64, h_k=7, w_k=7, stride=2, padding=3)]
    # (stage, n_blocks, c_in, c_mid, c_out, spatial)
    stages = [(2, 3, 64, 64, 256, 56), (3, 4, 256, 128, 512, 28),
              (4, 6, 512, 256, 1024, 14), (5, 3, 1024, 512, 2048, 7)]
    for s_id, nb, cin, cmid, cout, sp in stages:
        for b in range(nb):
            ci = cin if b == 0 else cout
            hi = sp * 2 if (b == 0 and s_id > 2) else sp
            st = 2 if (b == 0 and s_id > 2) else 1
            pre = f"s{s_id}b{b}"
            layers.append(LayerSpec(name=pre + "_1x1a", kind="conv", h_i=hi,
                                    w_i=hi, c_i=ci, c_o=cmid, h_k=1, w_k=1,
                                    stride=st, padding=0))
            layers.append(LayerSpec(name=pre + "_3x3", kind="conv", h_i=sp,
                                    w_i=sp, c_i=cmid, c_o=cmid, h_k=3, w_k=3,
                                    stride=1, padding=1))
            layers.append(LayerSpec(name=pre + "_1x1b", kind="conv", h_i=sp,
                                    w_i=sp, c_i=cmid, c_o=cout, h_k=1, w_k=1,
                                    stride=1, padding=0))
            if b == 0:
                layers.append(LayerSpec(name=pre + "_proj", kind="conv",
                                        h_i=hi, w_i=hi, c_i=ci, c_o=cout,
                                        h_k=1, w_k=1, stride=st, padding=0))
    layers.append(LayerSpec(name="fc", kind="fc", c_i=2048, c_o=1000))
    return layers


def googlenet_layers() -> list[LayerSpec]:
    layers = [
        LayerSpec(name="conv1", kind="conv", h_i=224, w_i=224, c_i=3, c_o=64,
                  h_k=7, w_k=7, stride=2, padding=3),
        LayerSpec(name="conv2a", kind="conv", h_i=56, w_i=56, c_i=64, c_o=64,
                  h_k=1, w_k=1),
        LayerSpec(name="conv2b", kind="conv", h_i=56, w_i=56, c_i=64, c_o=192,
                  h_k=3, w_k=3, padding=1),
    ]
    # inception: (name, spatial, c_in, 1x1, 3x3red, 3x3, 5x5red, 5x5, pool_proj)
    inc = [("3a", 28, 192, 64, 96, 128, 16, 32, 32),
           ("3b", 28, 256, 128, 128, 192, 32, 96, 64),
           ("4a", 14, 480, 192, 96, 208, 16, 48, 64),
           ("4b", 14, 512, 160, 112, 224, 24, 64, 64),
           ("4c", 14, 512, 128, 128, 256, 24, 64, 64),
           ("4d", 14, 512, 112, 144, 288, 32, 64, 64),
           ("4e", 14, 528, 256, 160, 320, 32, 128, 128),
           ("5a", 7, 832, 256, 160, 320, 32, 128, 128),
           ("5b", 7, 832, 384, 192, 384, 48, 128, 128)]
    for nm, sp, ci, c1, c3r, c3, c5r, c5, cp in inc:
        mk = lambda suf, cin, cout, k, pad: LayerSpec(
            name=f"inc{nm}_{suf}", kind="conv", h_i=sp, w_i=sp, c_i=cin,
            c_o=cout, h_k=k, w_k=k, padding=pad)
        layers += [mk("1x1", ci, c1, 1, 0), mk("3x3r", ci, c3r, 1, 0),
                   mk("3x3", c3r, c3, 3, 1), mk("5x5r", ci, c5r, 1, 0),
                   mk("5x5", c5r, c5, 5, 2), mk("pool", ci, cp, 1, 0)]
    layers.append(LayerSpec(name="fc", kind="fc", c_i=1024, c_o=1000))
    return layers


PAPER_NETWORKS = ("alexnet", "vgg16", "resnet50", "googlenet")


# ---------------------------------------------------------------------------
# Executable small CNN (forward, loss, mask-preserving training)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SmallCNNConfig:
    """CIFAR-scale CNN exercising conv + fc, Sense-prunable end to end."""
    img: int = 32
    channels: tuple = (16, 32, 64)
    kernel: int = 3
    n_classes: int = 10
    fc_hidden: int = 256


def smallcnn_init(cfg: SmallCNNConfig, generator: torch.Generator) -> dict:
    """Random f32 params of the reference's shapes and scaling (unit
    normals over sqrt(fan-in)), drawn from ``generator`` on its device:
    conv ``[Co, Ci, K, K]``, fc ``[out, in]``."""
    dev = generator.device

    def normal(shape, fan):
        return torch.randn(shape, generator=generator,
                           device=dev) / math.sqrt(fan)
    params = {}
    cin = 3
    for i, cout in enumerate(cfg.channels):
        params[f"conv{i}"] = normal((cout, cin, cfg.kernel, cfg.kernel),
                                    cin * cfg.kernel * cfg.kernel)
        cin = cout
    feat = cfg.channels[-1] * (cfg.img // (2 ** len(cfg.channels))) ** 2
    params["fc1"] = normal((cfg.fc_hidden, feat), feat)
    params["fc2"] = normal((cfg.n_classes, cfg.fc_hidden), cfg.fc_hidden)
    return params


def smallcnn_apply(cfg: SmallCNNConfig, params: dict, x: Tensor, *,
                   masks: dict | None = None, impl: str | None = None,
                   plan=None) -> Tensor:
    """x: NHWC ``[B, H, W, 3]`` -> logits ``[B, n_classes]``.

    ``masks`` (same keys) are the Sense pruning masks.  The layer-plan
    engine makes every dispatch decision (`engine.plan.plan_smallcnn`;
    ``impl`` None picks the CUDA kernels for params on the card): balanced
    conv masks run the chunked-im2col sparse conv, balanced fc masks the
    balanced GEMM, everything else dense.  Pass a prebuilt ``plan`` to
    skip plan construction.  Each conv is followed by ReLU and a 2x2 VALID
    max-pool; the features flatten in (H, W, C) order.
    """
    from ..engine.execute import apply_conv, apply_fc
    from ..engine.plan import plan_smallcnn
    if plan is None:
        plan = plan_smallcnn(cfg, params, masks, impl=impl)
    h = x
    for i in range(len(cfg.channels)):
        h = torch.relu(apply_conv(h, plan.layers[f"conv{i}"]))
        h = F.max_pool2d(h.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    h = h.reshape(h.shape[0], -1)
    h = torch.relu(apply_fc(h, plan.layers["fc1"]))
    return apply_fc(h, plan.layers["fc2"])


def smallcnn_loss(cfg: SmallCNNConfig, params: dict, batch: dict, *,
                  masks: dict | None = None, impl: str | None = None,
                  plan=None) -> Tensor:
    """Mean cross-entropy of the logits against ``batch["label"]``
    (differentiable in ``params``; with ``plan``, through its values)."""
    logits = smallcnn_apply(cfg, params, batch["image"], masks=masks,
                            impl=impl, plan=plan)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, batch["label"].long()[:, None]).mean()


def smallcnn_train_step(cfg: SmallCNNConfig, params: dict, state: dict,
                        batch: dict, opt_cfg, *, masks: dict | None = None,
                        plan=None, impl: str | None = None) -> tuple:
    """One mask-preserving AdamW step (the reference example's step):
    loss and gradients by autograd, `optim.adamw_update`, then the masks
    re-applied.  ``plan`` is an `engine.plan.TrainPlan` of these masks
    (built once; each step re-gathers its values from ``params``), else
    the plan is built in the loss.  Returns ``(params, state, loss)``."""
    from ..optim import adamw_update, apply_masks, value_and_grad

    def loss_fn(p):
        return smallcnn_loss(cfg, p, batch, masks=masks, impl=impl,
                             plan=None if plan is None else plan(p))
    loss, grads = value_and_grad(loss_fn, params)
    params, state, _ = adamw_update(opt_cfg, params, grads, state)
    if masks is not None:
        params = apply_masks(params, masks)
    return params, state, loss


def smallcnn_train(cfg: SmallCNNConfig, params: dict, data, steps: int, *,
                   masks: dict | None = None, lr: float = 1e-3,
                   start_step: int = 0, on_step=None, log=print) -> dict:
    """The reference example's training loop: AdamW (warmup 20, cosine to
    ``steps``, weight decay 0.01) from fresh moments on ``data.batch_at(
    start_step + s)``, masks re-applied after every step, the plan's
    structure built once (`engine.plan.TrainPlan`).  ``on_step(s, params,
    loss)`` is called after each step; the loss is logged five times."""
    from ..engine.plan import TrainPlan, plan_smallcnn
    from ..optim import AdamWConfig, adamw_init
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=20, total_steps=steps,
                          weight_decay=0.01)
    state = adamw_init(params)
    with torch.no_grad():
        plan = TrainPlan(plan_smallcnn(cfg, params, masks), masks)
    for s in range(steps):
        params, state, loss = smallcnn_train_step(
            cfg, params, state, data.batch_at(start_step + s), opt_cfg,
            masks=masks, plan=plan)
        if on_step is not None:
            on_step(s, params, loss)
        if (s + 1) % max(steps // 5, 1) == 0:
            log(f"    step {s + 1:4d} loss {float(loss):.4f}")
    return params


# batches of one `smallcnn_accuracy` evaluation (the reference example's)
EVAL_BATCHES = 10


@torch.no_grad()
def smallcnn_accuracy(cfg: SmallCNNConfig, params: dict, data, *,
                      masks: dict | None = None) -> float:
    """Accuracy over ``data.batch_at(10_000 + i)``, i < `EVAL_BATCHES`,
    the plan built once for the fixed weights."""
    from ..engine.plan import plan_smallcnn
    plan = plan_smallcnn(cfg, params, masks)
    correct = total = 0
    for i in range(EVAL_BATCHES):
        b = data.batch_at(10_000 + i)
        logits = smallcnn_apply(cfg, params, b["image"], plan=plan)
        correct += int((logits.argmax(-1) == b["label"]).sum())
        total += b["label"].shape[0]
    return correct / total
