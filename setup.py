"""Package metadata (≙ the reference's setup.py packaging of `gossip` v0.1).

The `[parse]` extra mirrors the reference's plotting dependencies
(setup.py:33-39 there); core deps are the baked-in JAX stack.
"""

from setuptools import find_packages, setup

setup(
    name="stochastic_gradient_push_tpu",
    version="0.1.0",
    description=("TPU-native decentralized data-parallel training: "
                 "AllReduce SGD, Stochastic Gradient Push, Overlap SGP, "
                 "D-PSGD, and AD-PSGD over time-varying gossip topologies "
                 "compiled to XLA collectives"),
    packages=find_packages(
        include=["stochastic_gradient_push_tpu",
                 "stochastic_gradient_push_tpu.*",
                 "stochastic_gradient_push_torch",
                 "stochastic_gradient_push_torch.*"]),
    # the native loader's C++ source ships with the package; data/native.py
    # builds it on demand (g++ + libjpeg) and falls back to PIL without it
    package_data={
        "stochastic_gradient_push_tpu.data": ["native_src/*.cc"],
        # the PyTorch port's CUDA kernels and the headers they include,
        # built with nvcc at first use
        "stochastic_gradient_push_torch": ["csrc/*.cu", "csrc/*.cuh"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
    ],
    extras_require={
        "parse": ["pandas", "matplotlib"],
        "imagefolder": ["Pillow"],
        "orbax": ["orbax-checkpoint"],
    },
    entry_points={
        "console_scripts": [
            "gossip-sgd=stochastic_gradient_push_tpu.run.gossip_sgd:main",
            "gossip-sgd-adpsgd="
            "stochastic_gradient_push_tpu.run.gossip_sgd_adpsgd:main",
            "sgplint=stochastic_gradient_push_tpu.analysis.cli:"
            "console_main",
        ],
    },
)
