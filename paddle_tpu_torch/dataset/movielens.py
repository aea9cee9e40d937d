"""MovieLens-1M loader (reference python/paddle/dataset/movielens.py
API): train()/test() yield
[user_id, gender_id, age_id, job_id, movie_id, category_ids,
 title_ids, score] — the recommender-system book-chapter input.

Reads ml-1m from $PADDLE_TPU_DATA_HOME/movielens when present;
otherwise serves deterministic synthetic interactions whose score
depends on (user, movie) features so the model has signal.
"""

import os

import numpy as np

_HOME = os.environ.get('PADDLE_TPU_DATA_HOME', '')

MAX_USER_ID = 6040
MAX_MOVIE_ID = 3952
MAX_JOB_ID = 20
AGES = [1, 18, 25, 35, 45, 50, 56]
CATEGORIES = ['Action', 'Adventure', 'Animation', "Children's", 'Comedy',
              'Crime', 'Documentary', 'Drama', 'Fantasy', 'Film-Noir',
              'Horror', 'Musical', 'Mystery', 'Romance', 'Sci-Fi',
              'Thriller', 'War', 'Western']
TITLE_VOCAB = 5175


def max_user_id():
    return MAX_USER_ID


def max_movie_id():
    return MAX_MOVIE_ID


def max_job_id():
    return MAX_JOB_ID


def age_table():
    return list(AGES)


def movie_categories():
    return {c: i for i, c in enumerate(CATEGORIES)}


def get_movie_title_dict():
    return {'t%d' % i: i for i in range(TITLE_VOCAB)}


def _synthetic(n, seed):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        user = int(rng.randint(1, MAX_USER_ID + 1))
        movie = int(rng.randint(1, MAX_MOVIE_ID + 1))
        gender = user % 2
        age = user % len(AGES)
        job = user % MAX_JOB_ID
        cats = [movie % len(CATEGORIES),
                (movie * 7 + 3) % len(CATEGORIES)]
        title = [(movie * 31 + k) % TITLE_VOCAB for k in range(3)]
        # rating correlates with feature agreement -> learnable
        score = 1.0 + ((user * 3 + movie * 5) % 9) / 2.0
        yield [user, gender, age, job, movie, cats, title, float(score)]


def _parse_ml1m(d):
    movies = {}
    cat_idx = movie_categories()
    title_dict = {}
    with open(os.path.join(d, 'movies.dat'), encoding='latin1') as f:
        for line in f:
            mid, title, cats = line.strip().split('::')
            words = title.split()
            for w in words:
                title_dict.setdefault(w, len(title_dict))
            movies[int(mid)] = (
                [cat_idx.get(c, 0) for c in cats.split('|')],
                [title_dict[w] for w in words])
    users = {}
    with open(os.path.join(d, 'users.dat'), encoding='latin1') as f:
        for line in f:
            uid, gender, age, job, _ = line.strip().split('::')
            users[int(uid)] = (0 if gender == 'M' else 1,
                               AGES.index(int(age)), int(job))
    with open(os.path.join(d, 'ratings.dat'), encoding='latin1') as f:
        for line in f:
            uid, mid, score, _ = line.strip().split('::')
            uid, mid = int(uid), int(mid)
            if uid in users and mid in movies:
                g, a, j = users[uid]
                cats, title = movies[mid]
                yield [uid, g, a, j, mid, cats, title, float(score)]


def _reader(is_test, seed):
    def reader():
        d = os.path.join(_HOME, 'movielens', 'ml-1m') if _HOME else None
        if d and os.path.isdir(d):
            for i, rec in enumerate(_parse_ml1m(d)):
                if (i % 10 == 9) == is_test:
                    yield rec
        else:
            yield from _synthetic(500 if is_test else 4000, seed)
    return reader


def train():
    return _reader(False, 21)


def test():
    return _reader(True, 22)
