"""Packaging (reference analogue: dl4ds setup.py)."""

import os
import re

from setuptools import setup, find_packages


def _version():
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, 'dl4ds_tpu', '__init__.py')) as fh:
        return re.search(r"__version__ = ['\"]([^'\"]+)['\"]",
                         fh.read()).group(1)


setup(
    name='dl4ds-tpu',
    version=_version(),
    description=('TPU-native (JAX/XLA/Pallas/pjit) deep learning for '
                 'empirical downscaling of gridded Earth-science data'),
    long_description=open('README.md').read(),
    long_description_content_type='text/markdown',
    packages=find_packages(exclude=['tests']),
    python_requires='>=3.10',
    install_requires=[
        'numpy',
        'jax',
        'flax',
        'optax',
        'scipy',
        'matplotlib',
        'absl-py',
    ],
    extras_require={
        'full': ['orbax-checkpoint', 'seaborn', 'xarray', 'pandas',
                 'opencv-python'],
        'test': ['pytest', 'opencv-python'],
        'torch': ['torch'],
    },
)
