"""Model presets (a copy of the reference's `models/presets.py`, over this
package's layers) — the benchmark configurations of BASELINE.json.

- reference_cnn: the reference's hardcoded net (cnn.c:416-428): 1x28x28 ->
  conv16 k3 s2 p1 (relu) -> conv32 k3 s2 p1 (relu) -> fc200 tanh -> fc200
  tanh -> fc10 softmax. 360,810 params (SURVEY.md 2.10) — the parity target.
- lenet5: classic LeCun-98 LeNet-5 (tanh + avg-pool), 28x28 padded to 32.
- lenet5_relu: modernized LeNet-5 (relu + max-pool) — the ≥99%-accuracy
  route (SURVEY.md §7 hard-part (f)).
- cifar3conv: the 3-conv-layer CIFAR-10 config.
- vgg_small: VGG-style conv blocks on CIFAR-10 (stress conv kernels).
- resnet8: small CIFAR-10 ResNet — beyond BASELINE.json; exercises the
  non-sequential (Residual) topology path.
"""

from __future__ import annotations

from .layers import (
    AvgPool,
    Conv,
    Dense,
    Flatten,
    GlobalAvgPool,
    MaxPool,
    Residual,
    Sequential,
)

MNIST_SHAPE = (28, 28, 1)
CIFAR_SHAPE = (32, 32, 3)


def reference_cnn() -> Sequential:
    return Sequential(
        name="reference_cnn",
        input_shape=MNIST_SHAPE,
        layers=(
            Conv(16, kernel=3, stride=2, padding=1, activation="relu"),
            Conv(32, kernel=3, stride=2, padding=1, activation="relu"),
            Dense(200, activation="tanh"),
            Dense(200, activation="tanh"),
            Dense(10, activation=None),
        ),
    )


def lenet5() -> Sequential:
    return Sequential(
        name="lenet5",
        input_shape=MNIST_SHAPE,
        layers=(
            Conv(6, kernel=5, padding=2, activation="tanh"),
            AvgPool(2),
            Conv(16, kernel=5, padding=0, activation="tanh"),
            AvgPool(2),
            Flatten(),
            Dense(120, activation="tanh"),
            Dense(84, activation="tanh"),
            Dense(10, activation=None),
        ),
    )


def lenet5_relu() -> Sequential:
    return Sequential(
        name="lenet5_relu",
        input_shape=MNIST_SHAPE,
        layers=(
            Conv(32, kernel=5, padding=2, activation="relu"),
            MaxPool(2),
            Conv(64, kernel=5, padding=0, activation="relu"),
            MaxPool(2),
            Flatten(),
            Dense(256, activation="relu"),
            Dense(128, activation="relu"),
            Dense(10, activation=None),
        ),
    )


def cifar3conv() -> Sequential:
    return Sequential(
        name="cifar3conv",
        input_shape=CIFAR_SHAPE,
        layers=(
            Conv(32, kernel=3, padding=1, activation="relu"),
            MaxPool(2),
            Conv(64, kernel=3, padding=1, activation="relu"),
            MaxPool(2),
            Conv(128, kernel=3, padding=1, activation="relu"),
            MaxPool(2),
            Flatten(),
            Dense(256, activation="relu"),
            Dense(10, activation=None),
        ),
    )


def vgg_small() -> Sequential:
    def block(c):
        return (
            Conv(c, kernel=3, padding=1, activation="relu"),
            Conv(c, kernel=3, padding=1, activation="relu"),
            MaxPool(2),
        )

    return Sequential(
        name="vgg_small",
        input_shape=CIFAR_SHAPE,
        layers=(
            *block(64),
            *block(128),
            *block(256),
            Flatten(),
            Dense(512, activation="relu"),
            Dense(10, activation=None),
        ),
    )


def resnet8() -> Sequential:
    """8-layer CIFAR-10 ResNet (3 residual stages over a conv stem).

    A second conv model family beyond the reference's straight-line nets —
    exercises the non-sequential topology path (Residual/GlobalAvgPool).
    """

    def block(c, stride=1):
        return Residual(
            body=(
                Conv(c, kernel=3, stride=stride, padding=1, activation="relu"),
                Conv(c, kernel=3, stride=1, padding=1, activation=None),
            ),
        )

    return Sequential(
        name="resnet8",
        input_shape=CIFAR_SHAPE,
        layers=(
            Conv(16, kernel=3, padding=1, activation="relu"),
            block(16),
            block(32, stride=2),
            block(64, stride=2),
            GlobalAvgPool(),
            Dense(10, activation=None),
        ),
    )


MODEL_PRESETS = {
    "reference_cnn": reference_cnn,
    "lenet5": lenet5,
    "lenet5_relu": lenet5_relu,
    "cifar3conv": cifar3conv,
    "vgg_small": vgg_small,
    "resnet8": resnet8,
}


def get_model(name: str, input_shape: tuple[int, ...] | None = None) -> Sequential:
    if name not in MODEL_PRESETS:
        raise KeyError(f"unknown model {name!r}; known: {sorted(MODEL_PRESETS)}")
    model = MODEL_PRESETS[name]()
    if input_shape is not None and tuple(input_shape) != model.input_shape:
        model = Sequential(model.layers, tuple(input_shape), model.name)
    return model
