"""MovieLens reader API (reference: python/paddle/dataset/movielens.py) with
synthetic ratings: rating = f(user_id, movie_id) + noise, so the
recommender-system workload (tests/book test_recommender_system) learns."""

from __future__ import annotations

import numpy as np

__all__ = ["train", "test", "max_user_id", "max_movie_id", "max_job_id",
           "age_table"]

_USERS, _MOVIES = 944, 1683
age_table = [1, 18, 25, 35, 45, 50, 56]


def max_user_id():
    return _USERS - 1


def max_movie_id():
    return _MOVIES - 1


def max_job_id():
    return 20


def _gen(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        u_bias = np.random.RandomState(7).randn(_USERS)
        m_bias = np.random.RandomState(8).randn(_MOVIES)
        for _ in range(n):
            u = int(rng.randint(1, _USERS))
            m = int(rng.randint(1, _MOVIES))
            gender = int(rng.randint(0, 2))
            age = int(rng.randint(0, len(age_table)))
            job = int(rng.randint(0, 21))
            category = [int(rng.randint(0, 18))]
            title = list(rng.randint(1, 5000, 3).astype("int64"))
            score = float(
                np.clip(3.0 + u_bias[u] + m_bias[m]
                        + 0.1 * rng.randn(), 1.0, 5.0)
            )
            yield [u, gender, age, job, m, category, title, score]

    return reader


def train(n=8192, seed=0):
    return _gen(n, seed)


def test(n=2048, seed=1):
    return _gen(n, seed)
