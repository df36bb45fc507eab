"""DCGAN (static graph), adversarial training in one step: the
counterpart of paddle_tpu/models/dcgan.py (reference analogue: the fluid
models repo's dc_gan, which alternates generator and discriminator
programs from Python).

ONE program computes both losses and applies BOTH optimizers through
``minimize(parameter_list=...)`` scoping (simultaneous GAN updates).
Discriminator weights are shared across the real and fake branches by
explicit parameter names; append_backward sums their gradients. The
generator's backward runs through the discriminator after the
discriminator's Adam ops, and must read the discriminator's weights from
before that update: the Executor keeps them for it (the in-place rule,
framework/executor.py), since the fused-Adam kernel updates a parameter
in place on the card.
"""
import numpy as np

from .. import layers, optimizer
from ..framework.program import Program, program_guard
from ..initializer import NormalInitializer
from ..param_attr import ParamAttr


class DCGANConfig(object):
    def __init__(self, noise_dim=64, base_channels=32, image_size=32,
                 image_channels=1, dtype="float32"):
        assert image_size % 4 == 0
        self.noise_dim = noise_dim
        self.base_channels = base_channels
        self.image_size = image_size
        self.image_channels = image_channels
        self.dtype = dtype


def _attr(name):
    return ParamAttr(name=name, initializer=NormalInitializer(scale=0.02))


def generator(z, cfg, name="gen", is_test=False):
    """(N, noise_dim) -> (N, C, S, S) in [-1, 1]."""
    s4 = cfg.image_size // 4
    c = cfg.base_channels
    h = layers.fc(z, c * 2 * s4 * s4,
                  param_attr=_attr(name + "_fc.w_0"),
                  bias_attr=ParamAttr(name=name + "_fc.b_0"))
    h = layers.reshape(h, [-1, c * 2, s4, s4])
    h = layers.batch_norm(h, act="relu", is_test=is_test,
                          param_attr=ParamAttr(name=name + "_bn0_s"),
                          bias_attr=ParamAttr(name=name + "_bn0_b"),
                          moving_mean_name=name + "_bn0_m",
                          moving_variance_name=name + "_bn0_v")
    h = layers.conv2d_transpose(
        h, c, filter_size=4, stride=2, padding=1,
        param_attr=_attr(name + "_dc1.w_0"),
        bias_attr=ParamAttr(name=name + "_dc1.b_0"))
    h = layers.batch_norm(h, act="relu", is_test=is_test,
                          param_attr=ParamAttr(name=name + "_bn1_s"),
                          bias_attr=ParamAttr(name=name + "_bn1_b"),
                          moving_mean_name=name + "_bn1_m",
                          moving_variance_name=name + "_bn1_v")
    h = layers.conv2d_transpose(
        h, cfg.image_channels, filter_size=4, stride=2, padding=1,
        param_attr=_attr(name + "_dc2.w_0"),
        bias_attr=ParamAttr(name=name + "_dc2.b_0"))
    return layers.tanh(h)


def discriminator(img, cfg, name="disc"):
    """(N, C, S, S) -> (N, 1) real/fake logit. Call it on both branches
    with the same ``name`` — weights are shared by parameter name."""
    c = cfg.base_channels
    h = layers.conv2d(img, c, filter_size=4, stride=2, padding=1,
                      param_attr=_attr(name + "_c0.w_0"),
                      bias_attr=ParamAttr(name=name + "_c0.b_0"))
    h = layers.leaky_relu(h, alpha=0.2)
    h = layers.conv2d(h, c * 2, filter_size=4, stride=2, padding=1,
                      param_attr=_attr(name + "_c1.w_0"),
                      bias_attr=ParamAttr(name=name + "_c1.b_0"))
    h = layers.leaky_relu(h, alpha=0.2)
    flat = c * 2 * (cfg.image_size // 4) ** 2
    h = layers.reshape(h, [0, flat])
    return layers.fc(h, 1, param_attr=_attr(name + "_fc.w_0"),
                     bias_attr=ParamAttr(name=name + "_fc.b_0"))


def _bce_logits(logits, target_value):
    t = layers.fill_constant_batch_size_like(logits, logits.shape,
                                             "float32", target_value)
    return layers.mean(
        layers.sigmoid_cross_entropy_with_logits(logits, t))


def dcgan_train_program(cfg, d_lr=2e-4, g_lr=2e-4, beta1=0.5):
    """Build the single adversarial step.

    Feeds: "real" (N,C,S,S) float32 in [-1,1]; "noise" (N,noise_dim).
    Fetches: d_loss, g_loss. Returns (main, startup, feeds, fetch).
    """
    main, startup = Program(), Program()
    with program_guard(main, startup):
        real = layers.data(
            "real", [cfg.image_channels, cfg.image_size, cfg.image_size],
            dtype="float32")
        noise = layers.data("noise", [cfg.noise_dim], dtype="float32")

        fake = generator(noise, cfg)
        d_real = discriminator(real, cfg)
        d_fake = discriminator(fake, cfg)

        d_loss = layers.elementwise_add(_bce_logits(d_real, 1.0),
                                        _bce_logits(d_fake, 0.0))
        g_loss = _bce_logits(d_fake, 1.0)

        params = main.global_block().all_parameters()
        d_params = [p for p in params if p.name.startswith("disc_")]
        g_params = [p for p in params if p.name.startswith("gen_")]
        optimizer.Adam(d_lr, beta1=beta1).minimize(
            d_loss, parameter_list=d_params)
        optimizer.Adam(g_lr, beta1=beta1).minimize(
            g_loss, parameter_list=g_params)
    return main, startup, ["real", "noise"], {"d_loss": d_loss,
                                              "g_loss": g_loss}


def synthetic_batch(cfg, batch_size, seed=0):
    rng = np.random.RandomState(seed)
    real = rng.uniform(-1, 1, (batch_size, cfg.image_channels,
                               cfg.image_size, cfg.image_size))
    noise = rng.randn(batch_size, cfg.noise_dim)
    return {"real": real.astype(np.float32),
            "noise": noise.astype(np.float32)}
