"""Helpers shared by the port's JAX-parity tests (imported by the
``tests/test_torch_*.py`` files that run both frameworks)."""
import jax
import numpy as np


def jax_perms(key, n_clients: int, n_rows: int) -> np.ndarray:
    """The per-client row orders the reference's phase drivers draw from
    ``key`` (engine.py ``RoundEngine``): one permutation per split key."""
    return np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n_rows))(
        jax.random.split(key, n_clients)))


def unimodal_perms(key, n_clients: int, n_rows: int):
    """(modality A, modality B) orders of the reference's unimodal phase."""
    ka, kb = jax.random.split(key)
    return jax_perms(ka, n_clients, n_rows), jax_perms(kb, n_clients, n_rows)


class JaxKeyPerms:
    """A permutation source for ``repro_torch.core.federation`` that
    replays the reference federation's key schedule: ``Federation``
    splits its key once per unimodal and once per paired phase
    (``_next_key``), starting from ``PRNGKey(seed)``."""

    def __init__(self, seed: int):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, phase: str, n_clients: int, n_rows: int):
        self.key, sub = jax.random.split(self.key)
        if phase == "unimodal":
            return unimodal_perms(sub, n_clients, n_rows)
        return jax_perms(sub, n_clients, n_rows)


def assert_trees_close(want, got, **tol):
    """Leafwise assert_allclose of a JAX tree against a numpy tree of the
    same structure (lists for the encoders' hidden layers)."""
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(b), np.asarray(a), **tol), want, got)
