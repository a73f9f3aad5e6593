"""MovieLens-1M readers (python/paddle/v2/dataset/movielens.py).

Record schema (v2): (user_id, gender_id, age_id, job_id, movie_id,
category_ids[list], title_ids[list], rating float).
"""

from __future__ import annotations

import re
import zipfile
from typing import Dict, List

from paddle_tpu_torch.data.datasets import common

URL = "https://files.grouplens.org/datasets/movielens/ml-1m.zip"
MD5 = "c4d9eecfca2ab87c1945afe126590906"

AGES = [1, 18, 25, 35, 45, 50, 56]
MAX_USER = 6040
MAX_MOVIE = 3952
CATEGORIES = [
    "Action", "Adventure", "Animation", "Children's", "Comedy", "Crime",
    "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror", "Musical",
    "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western",
]
_TITLE_VOCAB = 5000


def max_user_id() -> int:
    return MAX_USER


def max_movie_id() -> int:
    return MAX_MOVIE


def max_job_id() -> int:
    return 20


def age_table() -> List[int]:
    return list(AGES)


def movie_categories() -> List[str]:
    return list(CATEGORIES)


def _parse(path: str):
    users: Dict[int, tuple] = {}
    movies: Dict[int, tuple] = {}
    title_vocab: Dict[str, int] = {}
    with zipfile.ZipFile(path) as z:
        with z.open("ml-1m/users.dat") as f:
            for line in f.read().decode("latin1").splitlines():
                uid, gender, age, job, _zip = line.split("::")
                users[int(uid)] = (
                    0 if gender == "M" else 1,
                    AGES.index(int(age)),
                    int(job),
                )
        with z.open("ml-1m/movies.dat") as f:
            for line in f.read().decode("latin1").splitlines():
                mid, title, cats = line.split("::")
                title_words = re.findall(r"[A-Za-z0-9]+", title.lower())
                for w in title_words:
                    title_vocab.setdefault(w, len(title_vocab))
                movies[int(mid)] = (
                    [CATEGORIES.index(c) for c in cats.split("|") if c in CATEGORIES],
                    [title_vocab[w] for w in title_words],
                )
        ratings = []
        with z.open("ml-1m/ratings.dat") as f:
            for line in f.read().decode("latin1").splitlines():
                uid, mid, rating, _ts = line.split("::")
                ratings.append((int(uid), int(mid), float(rating)))
    return users, movies, ratings


def _real_reader(split: str):
    path = common.download(URL, "movielens", MD5)
    users, movies, ratings = _parse(path)
    cut = int(len(ratings) * 0.9)
    part = ratings[:cut] if split == "train" else ratings[cut:]

    def reader():
        for uid, mid, rating in part:
            if uid not in users or mid not in movies:
                continue
            g, a, j = users[uid]
            cats, title = movies[mid]
            yield uid, g, a, j, mid, cats, title, rating

    return reader


def _synthetic_reader(split: str, n: int):
    def reader():
        rs = common.rng("movielens." + split)
        for _ in range(n):
            uid = int(rs.randint(1, MAX_USER + 1))
            mid = int(rs.randint(1, MAX_MOVIE + 1))
            g = uid % 2
            a = uid % len(AGES)
            j = uid % 21
            cats = sorted(set(int(c) for c in rs.randint(0, len(CATEGORIES), 2)))
            title = rs.randint(0, _TITLE_VOCAB, size=int(rs.randint(2, 6))).tolist()
            rating = float((uid * 7 + mid * 3) % 5 + 1)
            yield uid, g, a, j, mid, cats, title, rating

    return reader


def train():
    return common.fetch_or_synthetic(
        lambda: _real_reader("train"), lambda: _synthetic_reader("train", 4096),
        "movielens.train",
    )


def test():
    return common.fetch_or_synthetic(
        lambda: _real_reader("test"), lambda: _synthetic_reader("test", 512),
        "movielens.test",
    )
