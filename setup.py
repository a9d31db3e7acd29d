"""Build the native runtime extension: python setup.py build_ext --inplace"""

import numpy as np
from setuptools import Extension, setup

setup(
    name="sage_icp_tpu",
    version="0.1.0",
    packages=[
        "sage_icp_tpu",
        "sage_icp_tpu.ops",
        "sage_icp_tpu.models",
        "sage_icp_tpu.parallel",
        "sage_icp_tpu.utils",
        "sage_icp_tpu.datasets",
        "sage_icp_tpu.metrics",
        "sage_icp_tpu.runtime",
        "sage_icp_tpu_torch",
        "sage_icp_tpu_torch.ops",
        "sage_icp_tpu_torch.models",
        "sage_icp_tpu_torch.utils",
    ],
    package_data={"sage_icp_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    ext_modules=[
        Extension(
            "sage_icp_tpu._native",
            sources=["sage_icp_tpu/native/src/native.cpp"],
            include_dirs=[np.get_include()],
            extra_compile_args=["-O3", "-std=c++17", "-Wall"],
            language="c++",
        )
    ],
)
