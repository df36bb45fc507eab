"""MovieLens-1M-style recommendation dataset
(ref python/paddle/dataset/movielens.py).

Contract: samples are ``user.value() + movie.value() + [rating]`` =
``[user_id, gender, age_bucket, job_id, movie_id, [category_ids],
[title_word_ids], rating]``; plus the meta accessors (max ids, category
list, title dict, MovieInfo/UserInfo records).  Synthetic catalogue:
deterministic users/movies with genre-conditioned ratings so factored
models (e.g. DeepFM) can fit real structure.
"""
import numpy as np

from . import synthetic

__all__ = [
    'train', 'test', 'get_movie_title_dict', 'max_movie_id', 'max_user_id',
    'age_table', 'movie_categories', 'max_job_id', 'user_info', 'movie_info'
]

age_table = [1, 18, 25, 35, 45, 50, 56]

_N_MOVIES = 400
_N_USERS = 600
_N_RATINGS = 8000
_CATEGORIES = [
    'Action', 'Adventure', 'Animation', "Children's", 'Comedy', 'Crime',
    'Documentary', 'Drama', 'Fantasy', 'Film-Noir', 'Horror', 'Musical',
    'Mystery', 'Romance', 'Sci-Fi', 'Thriller', 'War', 'Western'
]
_TITLE_VOCAB = 500
_MAX_JOB = 20


class MovieInfo(object):
    """Movie id, title and categories (ref movielens.py:48)."""

    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self):
        return [
            self.index, [CATEGORIES_DICT[c] for c in self.categories],
            [MOVIE_TITLE_DICT[w.lower()] for w in self.title.split()]
        ]

    def __str__(self):
        return "<MovieInfo id(%d), title(%s), categories(%s)>" % (
            self.index, self.title, self.categories)

    __repr__ = __str__


class UserInfo(object):
    """User id, gender, age bucket and job (ref movielens.py:74)."""

    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == 'M'
        self.age = age_table.index(int(age))
        self.job_id = int(job_id)

    def value(self):
        return [self.index, 0 if self.is_male else 1, self.age, self.job_id]

    def __str__(self):
        return "<UserInfo id(%d), gender(%s), age(%d), job(%d)>" % (
            self.index, "M" if self.is_male else "F",
            age_table[self.age], self.job_id)

    __repr__ = __str__


MOVIE_INFO = None
MOVIE_TITLE_DICT = None
CATEGORIES_DICT = None
USER_INFO = None


def __initialize_meta_info__():
    global MOVIE_INFO, MOVIE_TITLE_DICT, CATEGORIES_DICT, USER_INFO
    if MOVIE_INFO is not None:
        return
    CATEGORIES_DICT = {c: i for i, c in enumerate(_CATEGORIES)}
    MOVIE_TITLE_DICT = {"t%04d" % i: i for i in range(_TITLE_VOCAB)}
    MOVIE_INFO = {}
    for m in range(1, _N_MOVIES + 1):
        rng = synthetic.rng_for("ml", "movie", m)
        cats = list(rng.choice(_CATEGORIES,
                               size=int(rng.randint(1, 4)), replace=False))
        title = " ".join("t%04d" % rng.randint(_TITLE_VOCAB)
                         for _ in range(int(rng.randint(1, 5))))
        MOVIE_INFO[m] = MovieInfo(index=m, categories=cats, title=title)
    USER_INFO = {}
    for u in range(1, _N_USERS + 1):
        rng = synthetic.rng_for("ml", "user", u)
        USER_INFO[u] = UserInfo(
            index=u, gender='M' if rng.rand() < 0.5 else 'F',
            age=age_table[int(rng.randint(len(age_table)))],
            job_id=int(rng.randint(_MAX_JOB)))


def _rating(u, m):
    """Deterministic genre-affinity rating in [1, 5]."""
    __initialize_meta_info__()
    rng = synthetic.rng_for("ml", "rate", u, m)
    affin = synthetic.rng_for("ml", "affin", u).normal(
        0, 1, len(_CATEGORIES))
    cats = [CATEGORIES_DICT[c] for c in MOVIE_INFO[m].categories]
    score = 3.0 + float(np.mean([affin[c] for c in cats])) + \
        rng.normal(0, 0.5)
    return float(np.clip(np.round(score), 1, 5))


def __reader__(rand_seed=0, test_ratio=0.1, is_test=False):
    __initialize_meta_info__()
    rng = synthetic.rng_for("ml", "pairs", rand_seed)
    for _ in range(_N_RATINGS):
        in_test = rng.rand() < test_ratio
        u = int(rng.randint(1, _N_USERS + 1))
        m = int(rng.randint(1, _N_MOVIES + 1))
        if in_test != is_test:
            continue
        usr, mov = USER_INFO[u], MOVIE_INFO[m]
        yield usr.value() + mov.value() + [[_rating(u, m)]]


def __reader_creator__(**kwargs):
    return lambda: __reader__(**kwargs)


train = __reader_creator__(is_test=False)
test = __reader_creator__(is_test=True)


def get_movie_title_dict():
    __initialize_meta_info__()
    return MOVIE_TITLE_DICT


def max_movie_id():
    __initialize_meta_info__()
    return max(MOVIE_INFO, key=lambda m: MOVIE_INFO[m].index)


def max_user_id():
    __initialize_meta_info__()
    return max(USER_INFO, key=lambda u: USER_INFO[u].index)


def max_job_id():
    __initialize_meta_info__()
    return max(USER_INFO.values(), key=lambda u: u.job_id).job_id


def movie_categories():
    __initialize_meta_info__()
    return CATEGORIES_DICT


def user_info():
    __initialize_meta_info__()
    return USER_INFO


def movie_info():
    __initialize_meta_info__()
    return MOVIE_INFO


def unittest():
    for train_count, _ in enumerate(train()()):
        pass
    for test_count, _ in enumerate(test()()):
        pass
    print(train_count, test_count)


def fetch():
    __initialize_meta_info__()
