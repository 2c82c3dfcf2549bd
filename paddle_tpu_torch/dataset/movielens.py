"""MovieLens-1M. Counterpart of paddle_tpu/dataset/movielens.py (parity:
python/paddle/dataset/movielens.py), without a download: ml-1m.zip is
parsed when it is already under the data home, with the reference's
semantics
(movies.dat/users.dat/ratings.dat '::'-split, title '(year)' stripped,
age bucketed by age_table, rating scaled *2-5, deterministic
random.Random(0) 10% test split, samples
[uid, gender, age, job, mov_id, [categories], [title], [rating]]);
otherwise a synthetic fallback with the same field schema (bare
scalar ids, list-valued categories/title, nested [rating]), the same
samples as paddle_tpu's."""
import random
import re
import warnings
import zipfile

from . import _synth
from .common import cached_path, file_key

__all__ = ['train', 'test', 'get_movie_title_dict', 'max_movie_id',
           'max_user_id', 'max_job_id', 'age_table', 'movie_categories',
           'user_info', 'movie_info']

age_table = [1, 18, 25, 35, 45, 50, 56]

_N_USERS = 6040
_N_MOVIES = 3952
_N_JOBS = 21
_N_CATEGORIES = 18
_TITLE_VOCAB = 5175

_ARCHIVE = 'ml-1m.zip'
_META = {}   # file_key -> dict(movies, users, title_dict, cat_dict)


class MovieInfo(object):
    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title
        self._meta = None   # bound by _meta() for value()

    def value(self):
        """[index, [category ids], [title word ids]] (reference API)."""
        meta = self._meta
        return [self.index,
                [meta['cat_dict'][c] for c in self.categories],
                [meta['title_dict'][w.lower()]
                 for w in self.title.split()]]


class UserInfo(object):
    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == 'M'
        self.age = age_table.index(int(age))
        self.job_id = int(job_id)

    def value(self):
        return [self.index, 0 if self.is_male else 1, self.age,
                self.job_id]


def _meta():
    path = cached_path('movielens', _ARCHIVE)
    if path is None:
        return None
    key = file_key(path)
    if key in _META:
        return _META[key]
    try:
        pattern = re.compile(r'^(.*)\((\d+)\)$')
        movies, users = {}, {}
        title_words, categories = set(), set()
        with zipfile.ZipFile(file=path) as package:
            with package.open('ml-1m/movies.dat') as f:
                for line in f:
                    line = line.decode('latin1').strip()
                    movie_id, title, cats = line.split('::')
                    cats = cats.split('|')
                    categories.update(cats)
                    m = pattern.match(title)
                    title = m.group(1) if m else title
                    movies[int(movie_id)] = MovieInfo(movie_id, cats,
                                                      title)
                    for w in title.split():
                        title_words.add(w.lower())
            with package.open('ml-1m/users.dat') as f:
                for line in f:
                    uid, gender, age, job, _zip = line.decode(
                        'latin1').strip().split('::')
                    users[int(uid)] = UserInfo(uid, gender, age, job)
        meta = {
            'movies': movies, 'users': users,
            'title_dict': {w: i for i, w in
                           enumerate(sorted(title_words))},
            'cat_dict': {c: i for i, c in
                         enumerate(sorted(categories))},
        }
        for mov in movies.values():
            mov._meta = meta
    except Exception as e:
        warnings.warn("movielens cache unreadable (%s); using synthetic "
                      "fallback" % e)
        return None
    _META.clear()
    _META[key] = meta
    _synth.mark_real_data()
    return meta


def _real_reader(is_test, rand_seed=0, test_ratio=0.1):
    meta = _meta()
    if meta is None:
        return None
    path = cached_path('movielens', _ARCHIVE)

    def reader():
        rand = random.Random(x=rand_seed)
        with zipfile.ZipFile(file=path) as package:
            with package.open('ml-1m/ratings.dat') as f:
                for line in f:
                    take = (rand.random() < test_ratio) == is_test
                    if not take:
                        continue
                    parts = line.decode('latin1').strip().split('::')
                    if len(parts) != 4:
                        continue   # malformed/blank line
                    uid, mov_id, rating, _ts = parts
                    mov = meta['movies'].get(int(mov_id))
                    usr = meta['users'].get(int(uid))
                    if mov is None or usr is None:
                        continue   # rating references missing metadata
                    # reference scales ratings 1..5 -> -3..5
                    yield (usr.value() + mov.value() +
                           [[float(rating) * 2 - 5.0]])
    return reader


def max_user_id():
    meta = _meta()
    if meta is not None:
        return max(u.index for u in meta['users'].values())
    return _N_USERS


def max_movie_id():
    meta = _meta()
    if meta is not None:
        return max(m.index for m in meta['movies'].values())
    return _N_MOVIES


def max_job_id():
    meta = _meta()
    if meta is not None:
        return max(u.job_id for u in meta['users'].values())
    return _N_JOBS - 1


def movie_categories():
    meta = _meta()
    if meta is not None:
        return dict(meta['cat_dict'])
    return {('cat%d' % i): i for i in range(_N_CATEGORIES)}


def get_movie_title_dict():
    meta = _meta()
    if meta is not None:
        return dict(meta['title_dict'])
    return {('t%d' % i): i for i in range(_TITLE_VOCAB)}


def _sampler(name, n, salt=0):
    def reader():
        r = _synth.rng(name, salt)
        for _ in range(n):
            user_id = int(r.randint(1, _N_USERS + 1))
            gender = int(r.randint(0, 2))
            age = int(r.randint(0, len(age_table)))
            job = int(r.randint(0, _N_JOBS))
            movie_id = int(r.randint(1, _N_MOVIES + 1))
            n_cat = int(r.randint(1, 4))
            categories = [int(c) for c in
                          r.randint(0, _N_CATEGORIES, size=n_cat)]
            n_title = int(r.randint(2, 6))
            title = [int(t) for t in r.randint(0, _TITLE_VOCAB,
                                               size=n_title)]
            # learnable signal: score correlates with (user+movie)
            # parity; reference schema: bare scalars, rating in -3..5
            base = 3.0 + ((user_id + movie_id) % 5 - 2) * 0.8
            score = float(min(5.0, max(1.0, base + 0.3 * r.randn())))
            yield [user_id, gender, age, job, movie_id,
                   categories, title, [score * 2 - 5.0]]
    return reader


def train():
    real = _real_reader(is_test=False)
    if real is not None:
        return real
    return _sampler('movielens_train', 8192)


def test():
    real = _real_reader(is_test=True)
    if real is not None:
        return real
    return _sampler('movielens_test', 1024, salt=1)


def user_info():
    meta = _meta()
    if meta is not None:
        return dict(meta['users'])
    return {}


def movie_info():
    meta = _meta()
    if meta is not None:
        return dict(meta['movies'])
    return {}
