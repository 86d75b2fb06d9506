"""paddle.dataset.mq2007 parity — LETOR learning-to-rank records.

Reference: python/paddle/dataset/mq2007.py (Query :50, QueryList :106,
gen_point :169, gen_pair :188, gen_list :231, __reader__ :294).
Offline surrogate: query groups of 46-dim feature vectors whose
relevance is a noisy monotone function of a fixed scoring direction,
so pairwise/listwise rankers actually learn on it.  The reader
formats (pointwise / pairwise / listwise / plain_txt) and the
Query/QueryList record classes match the reference surface.
"""

import functools

import numpy as np

from ._synth import rng_for

FEATURE_DIM = 46
N_QUERIES = {"train": 120, "test": 30}
DOCS_PER_QUERY = (8, 20)

_SCORER = rng_for("mq2007", "w").standard_normal(FEATURE_DIM).astype(
    np.float32)

__all__ = ["train", "test", "Query", "QueryList", "gen_plain_txt",
           "gen_point", "gen_pair", "gen_list", "query_filter"]


class Query:
    """One (query, document) judgment: relevance score + dense
    features (mq2007.py:50)."""

    def __init__(self, query_id=-1, relevance_score=-1,
                 feature_vector=None, description=""):
        self.query_id = query_id
        self.relevance_score = relevance_score
        self.feature_vector = ([] if feature_vector is None
                               else feature_vector)
        self.description = description

    def __str__(self):
        return "%s %s %s" % (self.relevance_score, self.query_id,
                             " ".join(str(f) for f in self.feature_vector))

    def _parse_(self, text):
        """Parse a LETOR line: `rel qid:N 1:f1 2:f2 ... # comment`."""
        comment_position = text.find("#")
        if comment_position >= 0:
            self.description = text[comment_position + 1:].strip()
            text = text[:comment_position]
        parts = text.split()
        self.relevance_score = int(parts[0])
        self.query_id = int(parts[1].split(":")[1])
        self.feature_vector = [float(p.split(":")[1]) for p in parts[2:]]
        return self


class QueryList:
    """All judged documents of one query (mq2007.py:106)."""

    def __init__(self, querylist=None):
        self.query_list = [] if querylist is None else list(querylist)

    def __iter__(self):
        return iter(self.query_list)

    def __len__(self):
        return len(self.query_list)

    def __getitem__(self, i):
        return self.query_list[i]

    def _correct_ranking_(self):
        self.query_list.sort(key=lambda q: q.relevance_score, reverse=True)

    def _add_query(self, query):
        self.query_list.append(query)


def _synth_querylists(split):
    rs = rng_for("mq2007", split)
    lists = []
    for qid in range(N_QUERIES[split]):
        n_docs = int(rs.integers(*DOCS_PER_QUERY))
        ql = QueryList()
        for _ in range(n_docs):
            f = rs.standard_normal(FEATURE_DIM).astype(np.float32)
            score = float(f @ _SCORER) + 0.5 * rs.standard_normal()
            rel = int(np.clip(np.digitize(score, [-1.0, 1.0, 3.0]), 0, 2))
            ql._add_query(Query(query_id=qid, relevance_score=rel,
                                feature_vector=f.tolist()))
        lists.append(ql)
    return lists


def query_filter(querylists):
    """Drop queries whose judgments are all identical (no ranking
    signal) — mq2007.py:251."""
    kept = []
    for ql in querylists:
        rels = {q.relevance_score for q in ql}
        if len(rels) > 1:
            kept.append(ql)
    return kept


def gen_plain_txt(querylist):
    if not isinstance(querylist, QueryList):
        querylist = QueryList(querylist)
    for query in querylist:
        yield (query.query_id, query.relevance_score,
               np.array(query.feature_vector))


def gen_point(querylist):
    """Pointwise: (relevance, features) per document (mq2007.py:169)."""
    if not isinstance(querylist, QueryList):
        querylist = QueryList(querylist)
    for query in querylist:
        yield query.relevance_score, np.array(query.feature_vector)


def gen_pair(querylist, partial_order="full"):
    """Pairwise: (1, better_doc_features, worse_doc_features)
    (mq2007.py:188; the reference emits label 1 with the pair ordered
    higher-relevance first)."""
    if not isinstance(querylist, QueryList):
        querylist = QueryList(querylist)
    querylist._correct_ranking_()
    for i, qi in enumerate(querylist):
        for qj in querylist[i + 1:]:
            if qi.relevance_score > qj.relevance_score:
                yield (1, np.array(qi.feature_vector),
                       np.array(qj.feature_vector))


def gen_list(querylist):
    """Listwise: (normalized relevances, feature matrix)
    (mq2007.py:231)."""
    if not isinstance(querylist, QueryList):
        querylist = QueryList(querylist)
    relevance = np.array([q.relevance_score for q in querylist],
                         np.float32)
    total = relevance.sum()
    if total > 0:
        relevance = relevance / total
    features = np.array([q.feature_vector for q in querylist],
                        np.float32)
    yield relevance.tolist(), features


def __reader__(split, format="pairwise", shuffle=False, fill_missing=-1):
    querylists = query_filter(_synth_querylists(split))
    if shuffle:
        rng_for("mq2007", split + "/shuffle").shuffle(querylists)
    for querylist in querylists:
        if format == "plain_txt":
            yield next(gen_plain_txt(querylist))
        elif format == "pointwise":
            yield next(gen_point(querylist))
        elif format == "pairwise":
            for pair in gen_pair(querylist):
                yield pair
        elif format == "listwise":
            yield next(gen_list(querylist))
        else:
            raise ValueError("unknown format %r" % format)


train = functools.partial(__reader__, "train")
test = functools.partial(__reader__, "test")
