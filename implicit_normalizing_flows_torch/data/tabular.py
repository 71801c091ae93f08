"""Tabular density-estimation data (``data/tabular.py`` of the JAX package,
``:15-30, 90-159``): the paper-standard splits and normalisation, POWER from
its preprocessed file (``power/data.npy`` under ``data_root``), the
correlated-Gaussian stand-in of a dataset's dimensionality when its file is
absent, and an epoch iterator. Plain numpy arrays, float32; the same seed
gives the JAX package's bytes.

Only POWER's loader is ported; GAS, HEPMASS, MINIBOONE and BSDS300 take the
stand-in or raise until their files are in the repository.
"""
from __future__ import annotations

import os

import numpy as np

# Paper-standard dims, used by the synthetic stand-in
TABULAR_DIMS = {"power": 6, "gas": 8, "hepmass": 21, "miniboone": 43, "bsds300": 63}


def normalize_raw_data(data, mu, s):
    return (data - mu) / s


def make_tabular_train_valid_split(data, frac):
    n_valid = int(frac * data.shape[0])
    return data[0:-n_valid], data[-n_valid:]


def make_tabular_train_valid_test_split(data, frac):
    n_test = int(frac * data.shape[0])
    test_data = data[-n_test:]
    train_data, valid_data = make_tabular_train_valid_split(data[0:-n_test], frac)
    return train_data, valid_data, test_data


def get_power_raw(data_root, rng=None):
    """POWER with its two dropped columns, the noise injection of the
    reference (``tabular.py:137-163``), the 10% splits and the train+valid
    normalisation."""
    rng = rng or np.random
    data = np.load(os.path.join(data_root, "power/data.npy"))
    rng.shuffle(data)
    n = data.shape[0]
    data = np.delete(data, 3, axis=1)
    data = np.delete(data, 1, axis=1)
    noise = np.hstack((0.001 * rng.rand(n, 1), 0.01 * rng.rand(n, 1), rng.rand(n, 3),
                       np.zeros((n, 1))))
    train, valid, test = make_tabular_train_valid_test_split(data + noise, 0.1)
    stack = np.vstack((train, valid))
    mu, s = stack.mean(axis=0), stack.std(axis=0)
    return tuple(normalize_raw_data(d, mu, s) for d in (train, valid, test))


def synthetic_tabular(name, n=100_000):
    """The stand-in of ``name``'s dimensionality (``tabular.py:141-148``):
    ``tanh(z A) + 0.1 noise`` from ``RandomState(0)``, standardised, split
    10% / 10%."""
    d = TABULAR_DIMS[name]
    rng = np.random.RandomState(0)
    A = rng.randn(d, d) / np.sqrt(d)
    z = rng.randn(n, d)
    data = np.tanh(z @ A) + 0.1 * rng.randn(n, d)
    data = (data - data.mean(0)) / data.std(0)
    return make_tabular_train_valid_test_split(data, 0.1)


def get_tabular_datasets(name, data_root, synthetic_fallback=False, synthetic_n=100_000):
    """float32 (train, valid, test) of ``name`` (``get_tabular_datasets``,
    ``tabular.py:130-150``); with ``synthetic_fallback`` the stand-in when
    the file is absent or its loader is not ported."""
    if name not in TABULAR_DIMS:
        raise NotImplementedError(name)
    try:
        if name != "power":
            raise NotImplementedError(f"the {name} loader is not ported")
        splits = get_power_raw(data_root)
    except (FileNotFoundError, OSError, NotImplementedError):
        if not synthetic_fallback:
            raise
        splits = synthetic_tabular(name, synthetic_n)
    return tuple(np.asarray(d, np.float32) for d in splits)


def batch_iterator(data, batch_size, rng, shuffle=True, drop_last=True):
    """Epoch iterator over a host-resident array."""
    n = data.shape[0]
    idx = rng.permutation(n) if shuffle else np.arange(n)
    end = n - (n % batch_size) if drop_last else n
    for i in range(0, end, batch_size):
        yield data[idx[i:i + batch_size]]
