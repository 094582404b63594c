"""Quantized test data whose arithmetic is exact in float32.

Vectors and queries sit on the grid 1/64. The int8 codec has scale 1/32
and zero 0, and each int8 query has one coordinate at ±127/64, so its
query step sq is 1/2048; the PQ codebooks are the reference's, rounded to
the grid. Every ADC distance, norm, error and their sums are then exact
whatever the summation order, so the JAX reference and the PyTorch port
must agree on every float field, not only to a tolerance.
"""
import jax.numpy as jnp
import numpy as np

from repro.quant import codecs as J


def on_grid(a, step=64):
    return (np.round(np.asarray(a) * step) / step).astype(np.float32)


def grid_queries(q, precision):
    """Grid queries; under int8 with coordinate 0 at ±127/64."""
    q = np.clip(on_grid(q), -127 / 64, 127 / 64)
    if precision == "int8":
        q[:, 0] = np.where(q[:, 0] < 0, -127 / 64, 127 / 64)
    return q.astype(np.float32)


def grid_index(precision, vectors, pq_subspaces=8, pq_centroids=32,
               pq_levels=2):
    """A reference Int8Index / PQIndex over grid `vectors`, exact on them."""
    v = jnp.asarray(vectors)
    if precision == "int8":
        scale = jnp.full((v.shape[1],), 1 / 32, jnp.float32)
        zero = jnp.zeros((v.shape[1],), jnp.float32)
        codes, norms, err = J.encode_int8(scale, zero, v)
        return J.Int8Index(codes=codes, scale=scale, zero=zero, norms=norms,
                           err=err)
    books = J.train_pq(vectors, pq_subspaces, pq_centroids, 8, 0,
                       n_levels=pq_levels)
    books = jnp.asarray(on_grid(books))
    codes, norms, err = J.encode_pq(books, v)
    return J.PQIndex(codes=codes, codebooks=books, norms=norms, err=err)
