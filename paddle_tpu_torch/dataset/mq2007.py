"""MQ2007 learning-to-rank dataset (counterpart of
paddle_tpu/dataset/mq2007.py; ref python/paddle/dataset/mq2007.py).

Contract: ``__reader__(filepath, format, shuffle, fill_missing)`` with
format in {"pointwise", "pairwise", "listwise"}:
  pointwise -> (float32[46] features, score)
  pairwise  -> (high_features, low_features) preference pairs
  listwise  -> (query_list_of_score, query_list_of_features)
plus the Query/QueryList record classes.  Synthetic payload: per-query
documents whose relevance is a noisy linear function of the 46 LETOR
features, so ranking losses order documents meaningfully.
"""
import functools

import numpy as np

from . import synthetic

FEATURE_DIM = 46
N_QUERIES = {"train": 120, "test": 40}
DOCS_PER_QUERY = (5, 15)


class Query(object):
    """One (query, document) pair: relevance score + 46-dim LETOR
    feature vector (ref mq2007.py:50)."""

    def __init__(self, query_id=-1, relevance_score=-1,
                 feature_vector=None, description=""):
        self.query_id = query_id
        self.relevance_score = relevance_score
        self.feature_vector = feature_vector or []
        self.description = description

    def __str__(self):
        return "%s %s %s" % (str(self.relevance_score), str(self.query_id),
                             " ".join(str(f) for f in self.feature_vector))


class QueryList(object):
    """All documents of one query id (ref mq2007.py:104)."""

    def __init__(self, querylist=None):
        self.query_id = -1
        self.querylist = querylist or []
        if self.querylist:
            self.query_id = self.querylist[0].query_id

    def __iter__(self):
        return iter(self.querylist)

    def __len__(self):
        return len(self.querylist)

    def __getitem__(self, i):
        return self.querylist[i]

    def _correct_ranking_(self):
        self.querylist.sort(key=lambda x: -x.relevance_score)

    def _add_query(self, query):
        if self.query_id == -1:
            self.query_id = query.query_id
        self.querylist.append(query)


def _make_querylists(split):
    rng_w = synthetic.rng_for("mq2007", "w")
    w = rng_w.normal(0, 1, FEATURE_DIM)
    lists = []
    for q in range(N_QUERIES[split]):
        rng = synthetic.rng_for("mq2007", split, q)
        ql = QueryList()
        for d in range(int(rng.randint(*DOCS_PER_QUERY))):
            fv = rng.normal(0, 1, FEATURE_DIM)
            score = int(np.clip(np.round(
                fv.dot(w) / np.sqrt(FEATURE_DIM) * 1.2 +
                rng.normal(0, 0.3) + 1.0), 0, 2))
            ql._add_query(Query(query_id=q, relevance_score=score,
                                feature_vector=list(fv.astype(np.float32))))
        ql._correct_ranking_()
        lists.append(ql)
    return lists


def gen_plain_txt(querylist):
    """(query_id, score, features) rows (ref mq2007.py:148)."""
    for query in querylist:
        yield querylist.query_id, query.relevance_score, \
            np.array(query.feature_vector)


def gen_point(querylist):
    """Pointwise: (features, score) (ref mq2007.py:169)."""
    for query in querylist:
        yield np.array(query.feature_vector), query.relevance_score


def gen_pair(querylist, partial_order="full"):
    """Pairwise preference samples (ref mq2007.py:188): yields
    (high_feature, low_feature) for doc pairs with differing scores."""
    docs = sorted(querylist, key=lambda x: -x.relevance_score)
    for i, hi in enumerate(docs):
        for lo in docs[i + 1:]:
            if hi.relevance_score > lo.relevance_score:
                yield (np.array(hi.feature_vector),
                       np.array(lo.feature_vector))
                if partial_order != "full":
                    break


def gen_list(querylist):
    """Listwise: (scores, features) per query (ref mq2007.py:231)."""
    relevance_score_list = [[q.relevance_score] for q in querylist]
    feature_vector_list = [q.feature_vector for q in querylist]
    yield np.array(relevance_score_list), np.array(feature_vector_list)


def query_filter(querylists):
    """Drop queries whose docs all share one relevance level
    (ref mq2007.py:251)."""
    filtered = []
    for ql in querylists:
        if len({q.relevance_score for q in ql}) > 1:
            filtered.append(ql)
    return filtered


def load_from_text(filepath, shuffle=False, fill_missing=-1):
    """Synthetic equivalent of parsing the LETOR text file: the
    train/test substring of ``filepath`` picks the split."""
    split = "test" if "test" in str(filepath) else "train"
    return _make_querylists(split)


def __reader__(filepath, format="pairwise", shuffle=False, fill_missing=-1):
    querylists = query_filter(
        load_from_text(filepath, shuffle=shuffle,
                       fill_missing=fill_missing))
    gen = {"plain_txt": gen_plain_txt, "pointwise": gen_point,
           "pairwise": gen_pair, "listwise": gen_list}[format]
    for ql in querylists:
        for sample in gen(ql):
            yield sample


train = functools.partial(__reader__, filepath="MQ2007/Fold1/train.txt")
test = functools.partial(__reader__, filepath="MQ2007/Fold1/test.txt")


def fetch():
    next(train())
