"""``paddle.text.datasets``: parsers for the reference's seven text
datasets (the counterpart of ``paddle_tpu/text/datasets.py``; reference:
python/paddle/text/datasets/{imdb,imikolov,movielens,conll05,
uci_housing,wmt14,wmt16}.py).

Each class keeps the reference's constructor, archive layout,
vocabulary rules and ``__getitem__`` tuple.  They read local archives in
the original formats only: ``data_file`` (and its siblings) must point
at one, and a missing one raises with the expected layout spelled out.
Nothing downloads."""
from __future__ import annotations

import collections
import gzip
import os
import re
import string
import tarfile
import zipfile

import numpy as np

from ..io import Dataset

__all__ = ["Imdb", "Imikolov", "Movielens", "Conll05st", "UCIHousing",
           "WMT14", "WMT16"]


def _need_file(path, name, layout):
    if path is None:
        raise ValueError(
            f"{name}: data_file must point at a local archive (no network "
            f"in this environment; downloads are not supported). Expected "
            f"format: {layout}")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{name}: {path} does not exist")
    return path


class Imdb(Dataset):
    """reference: text/datasets/imdb.py:33 (aclImdb tar; pos=0 / neg=1;
    freq>cutoff vocab sorted by (-freq, word) with trailing <unk>)."""

    def __init__(self, data_file=None, mode="train", cutoff=150,
                 download=True):
        assert mode.lower() in ("train", "test"), mode
        self.mode = mode.lower()
        self.data_file = _need_file(
            data_file, "Imdb",
            "aclImdb_v1.tar.gz with members aclImdb/{train,test}/"
            "{pos,neg}/*.txt")
        self.word_idx = self._build_word_dict(cutoff)
        self._load_anno()

    def _tokenize(self, pattern):
        docs = []
        table = bytes.maketrans(b"", b"")
        punct = string.punctuation.encode()
        with tarfile.open(self.data_file) as tf:
            for m in tf:
                if pattern.match(m.name):
                    raw = tf.extractfile(m).read().rstrip(b"\n\r")
                    docs.append(raw.translate(table, punct).lower().split())
        return docs

    def _build_word_dict(self, cutoff):
        freq = collections.defaultdict(int)
        pat = re.compile(r"aclImdb/((train)|(test))/((pos)|(neg))/.*\.txt$")
        for doc in self._tokenize(pat):
            for w in doc:
                freq[w] += 1
        kept = sorted(((w, c) for w, c in freq.items() if c > cutoff),
                      key=lambda x: (-x[1], x[0]))
        word_idx = {w: i for i, (w, _) in enumerate(kept)}
        word_idx[b"<unk>"] = len(word_idx)
        return word_idx

    def _load_anno(self):
        unk = self.word_idx[b"<unk>"]
        self.docs, self.labels = [], []
        for label, sub in ((0, "pos"), (1, "neg")):
            pat = re.compile(rf"aclImdb/{self.mode}/{sub}/.*\.txt$")
            for doc in self._tokenize(pat):
                self.docs.append([self.word_idx.get(w, unk) for w in doc])
                self.labels.append(label)

    def __getitem__(self, idx):
        return np.array(self.docs[idx]), np.array([self.labels[idx]])

    def __len__(self):
        return len(self.docs)


class Imikolov(Dataset):
    """reference: text/datasets/imikolov.py:76 (PTB tar; NGRAM windows or
    SEQ <s>/<e> pairs; vocab from train+valid with freq>min_word_freq)."""

    def __init__(self, data_file=None, data_type="NGRAM", window_size=-1,
                 mode="train", min_word_freq=50, download=True):
        assert data_type.upper() in ("NGRAM", "SEQ"), data_type
        assert mode.lower() in ("train", "test"), mode
        self.data_type = data_type.upper()
        self.mode = mode.lower()
        self.window_size = window_size
        self.data_file = _need_file(
            data_file, "Imikolov",
            "simple-examples tar with ./simple-examples/data/"
            "ptb.{train,valid,test}.txt")
        self.word_idx = self._build_word_dict(min_word_freq)
        self._load_anno()

    @staticmethod
    def _word_count(f, freq):
        for line in f:
            for w in line.strip().split():
                freq[w] += 1
            freq[b"<s>"] += 1
            freq[b"<e>"] += 1
        return freq

    def _member(self, tf, suffix):
        # suffix match tolerates both "./simple-examples/..." and
        # "simple-examples/..." member spellings
        for name in tf.getnames():
            if name.endswith(suffix):
                return tf.extractfile(name)
        raise KeyError(f"Imikolov: no member ending in {suffix} in "
                       f"{self.data_file}")

    def _build_word_dict(self, cutoff):
        with tarfile.open(self.data_file) as tf:
            freq = collections.defaultdict(int)
            self._word_count(self._member(tf, "data/ptb.train.txt"), freq)
            self._word_count(self._member(tf, "data/ptb.valid.txt"), freq)
        freq.pop(b"<unk>", None)
        kept = sorted(((w, c) for w, c in freq.items() if c > cutoff),
                      key=lambda x: (-x[1], x[0]))
        word_idx = {w: i for i, (w, _) in enumerate(kept)}
        word_idx[b"<unk>"] = len(word_idx)
        return word_idx

    def _load_anno(self):
        self.data = []
        unk = self.word_idx[b"<unk>"]
        # reference: imikolov.py maps mode directly onto the split file —
        # test mode reads ptb.test.txt (valid is only for vocab building)
        fname = f"data/ptb.{self.mode}.txt"
        with tarfile.open(self.data_file) as tf:
            for line in self._member(tf, fname):
                if self.data_type == "NGRAM":
                    assert self.window_size > -1, "Invalid gram length"
                    toks = [b"<s>"] + line.strip().split() + [b"<e>"]
                    if len(toks) >= self.window_size:
                        ids = [self.word_idx.get(w, unk) for w in toks]
                        for i in range(self.window_size, len(ids) + 1):
                            self.data.append(
                                tuple(ids[i - self.window_size:i]))
                else:  # SEQ
                    ids = [self.word_idx.get(w, unk)
                           for w in line.strip().split()]
                    src = [self.word_idx[b"<s>"]] + ids
                    trg = ids + [self.word_idx[b"<e>"]]
                    if 0 < self.window_size < len(src):
                        continue
                    self.data.append((src, trg))

    def __getitem__(self, idx):
        return tuple(np.array(d) for d in self.data[idx])

    def __len__(self):
        return len(self.data)


class _MovieInfo:
    """reference: movielens.py:42 MovieInfo value layout."""

    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self, categories_dict, title_dict):
        return [[self.index],
                [categories_dict[c] for c in self.categories],
                [title_dict[w.lower()] for w in self.title.split()]]


class _UserInfo:
    """reference: movielens.py:67 UserInfo value layout."""

    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == "M"
        self.age = int(age)
        self.job_id = int(job_id)

    def value(self):
        return [[self.index], [0 if self.is_male else 1], [self.age],
                [self.job_id]]


class Movielens(Dataset):
    """reference: text/datasets/movielens.py:96 (ml-1m zip: movies.dat /
    users.dat / ratings.dat with :: separators; seeded random train/test
    split; rating rescaled to [-5, 5] via r*2-5)."""

    def __init__(self, data_file=None, mode="train", test_ratio=0.1,
                 rand_seed=0, download=True):
        assert mode.lower() in ("train", "test"), mode
        self.mode = mode.lower()
        self.data_file = _need_file(
            data_file, "Movielens",
            "ml-1m.zip with ml-1m/{movies,users,ratings}.dat "
            "('::'-separated, latin-1)")
        self.test_ratio = test_ratio
        np.random.seed(rand_seed)
        self._load_meta_info()
        self._load_data()

    def _load_meta_info(self):
        pat = re.compile(r"^(.*)\((\d+)\)$")
        self.movie_info, self.user_info = {}, {}
        title_words, categories = set(), set()
        with zipfile.ZipFile(self.data_file) as z:
            with z.open("ml-1m/movies.dat") as f:
                for line in f:
                    mid, title, cats = (line.decode("latin-1").strip()
                                        .split("::"))
                    cats = cats.split("|")
                    categories.update(cats)
                    title = pat.match(title).group(1).strip()
                    title_words.update(w.lower() for w in title.split())
                    self.movie_info[int(mid)] = _MovieInfo(mid, cats, title)
            with z.open("ml-1m/users.dat") as f:
                for line in f:
                    uid, gender, age, job, _ = (line.decode("latin-1")
                                                .strip().split("::"))
                    self.user_info[int(uid)] = _UserInfo(uid, gender, age,
                                                         job)
        self.movie_title_dict = {w: i for i, w in enumerate(title_words)}
        self.categories_dict = {c: i for i, c in enumerate(categories)}

    def _load_data(self):
        self.data = []
        is_test = self.mode == "test"
        with zipfile.ZipFile(self.data_file) as z:
            with z.open("ml-1m/ratings.dat") as f:
                for line in f:
                    if (np.random.random() < self.test_ratio) != is_test:
                        continue
                    uid, mid, rating, _ = (line.decode("latin-1").strip()
                                           .split("::"))
                    usr = self.user_info[int(uid)]
                    mov = self.movie_info[int(mid)]
                    self.data.append(
                        usr.value()
                        + mov.value(self.categories_dict,
                                    self.movie_title_dict)
                        + [[float(rating) * 2 - 5.0]])

    def __getitem__(self, idx):
        return tuple(np.array(d) for d in self.data[idx])

    def __len__(self):
        return len(self.data)


class Conll05st(Dataset):
    """reference: text/datasets/conll05.py:99 (conll05st-release tar with
    gzipped test.wsj words/props columns; separate word/verb/target dict
    files; emits the 9-slot SRL tuple with predicate context windows)."""

    UNK_IDX = 0

    def __init__(self, data_file=None, word_dict_file=None,
                 verb_dict_file=None, target_dict_file=None, emb_file=None,
                 download=True):
        self.data_file = _need_file(
            data_file, "Conll05st",
            "conll05st-release tar with conll05st-release/test.wsj/"
            "{words/test.wsj.words.gz,props/test.wsj.props.gz}")
        self.word_dict_file = _need_file(word_dict_file, "Conll05st",
                                         "word dict, one token per line")
        self.verb_dict_file = _need_file(verb_dict_file, "Conll05st",
                                         "verb dict, one token per line")
        self.target_dict_file = _need_file(
            target_dict_file, "Conll05st",
            "target label dict with B-*/I-*/O tags")
        self.emb_file = emb_file
        self.word_dict = self._load_dict(self.word_dict_file)
        self.predicate_dict = self._load_dict(self.verb_dict_file)
        self.label_dict = self._load_label_dict(self.target_dict_file)
        self._load_anno()

    @staticmethod
    def _load_dict(path):
        with open(path) as f:
            return {ln.strip(): i for i, ln in enumerate(f)}

    @staticmethod
    def _load_label_dict(path):
        tags = set()
        with open(path) as f:
            for ln in f:
                ln = ln.strip()
                if ln.startswith(("B-", "I-")):
                    tags.add(ln[2:])
        d, i = {}, 0
        for tag in sorted(tags):
            d["B-" + tag] = i
            d["I-" + tag] = i + 1
            i += 2
        d["O"] = i
        return d

    @staticmethod
    def _parse_props(lbl):
        """Star-bracket props column -> BIO sequence (conll05.py:200)."""
        out, cur, inside = [], "O", False
        for tok in lbl:
            if tok == "*":
                out.append("I-" + cur if inside else "O")
            elif tok == "*)":
                out.append("I-" + cur)
                inside = False
            elif "(" in tok:
                cur = tok[1:tok.find("*")]
                out.append("B-" + cur)
                inside = ")" not in tok
            else:
                raise RuntimeError(f"Unexpected label: {tok}")
        return out

    def _load_anno(self):
        self.sentences, self.predicates, self.labels = [], [], []
        with tarfile.open(self.data_file) as tf:
            wf = tf.extractfile(
                "conll05st-release/test.wsj/words/test.wsj.words.gz")
            pf = tf.extractfile(
                "conll05st-release/test.wsj/props/test.wsj.props.gz")
            with gzip.GzipFile(fileobj=wf) as words, \
                    gzip.GzipFile(fileobj=pf) as props:
                sentence, columns = [], []
                for wline, pline in zip(words, props):
                    word = wline.decode().strip()
                    cols = pline.decode().strip().split()
                    if cols:  # in-sentence row: word + one col per verb
                        sentence.append(word)
                        columns.append(cols)
                        continue
                    # end of sentence: column 0 = verbs, 1.. = props
                    if columns:
                        verbs = [c[0] for c in columns if c[0] != "-"]
                        n_props = len(columns[0]) - 1
                        for v in range(n_props):
                            lbl = [c[v + 1] for c in columns]
                            self.sentences.append(list(sentence))
                            self.predicates.append(verbs[v])
                            self.labels.append(self._parse_props(lbl))
                    sentence, columns = [], []

    def __getitem__(self, idx):
        sent, pred, labels = (self.sentences[idx], self.predicates[idx],
                              self.labels[idx])
        n = len(sent)
        vi = labels.index("B-V")
        mark = [0] * n
        ctx = {}
        for off, key in ((-2, "n2"), (-1, "n1"), (0, "0"), (1, "p1"),
                         (2, "p2")):
            j = vi + off
            if 0 <= j < n:
                mark[j] = 1
                ctx[key] = sent[j]
            else:
                ctx[key] = "bos" if off < 0 else "eos"
        wd, UNK = self.word_dict, self.UNK_IDX
        word_idx = [wd.get(w, UNK) for w in sent]
        ctxs = [[wd.get(ctx[k], UNK)] * n
                for k in ("n2", "n1", "0", "p1", "p2")]
        pred_idx = [self.predicate_dict.get(pred)] * n
        label_idx = [self.label_dict.get(w) for w in labels]
        return tuple(np.array(a) for a in
                     [word_idx, *ctxs, pred_idx, mark, label_idx])

    def __len__(self):
        return len(self.sentences)

    def get_dict(self):
        return self.word_dict, self.predicate_dict, self.label_dict

    def get_embedding(self):
        if self.emb_file is None:
            raise ValueError("Conll05st: emb_file was not provided")
        return self.emb_file


class UCIHousing(Dataset):
    """reference: text/datasets/uci_housing.py:69 (whitespace floats, 14
    per row; feature-wise (x-avg)/(max-min) normalisation; 80/20
    train/test split)."""

    def __init__(self, data_file=None, mode="train", download=True):
        assert mode.lower() in ("train", "test"), mode
        self.mode = mode.lower()
        self.data_file = _need_file(
            data_file, "UCIHousing",
            "housing.data: whitespace-separated floats, 14 per record")
        self._load_data()

    def _load_data(self, feature_num=14, ratio=0.8):
        data = np.fromfile(self.data_file, sep=" ")
        data = data.reshape(data.shape[0] // feature_num, feature_num)
        mx, mn, avg = (data.max(axis=0), data.min(axis=0),
                       data.mean(axis=0))
        for i in range(feature_num - 1):
            data[:, i] = (data[:, i] - avg[i]) / (mx[i] - mn[i])
        offset = int(data.shape[0] * ratio)
        self.data = data[:offset] if self.mode == "train" else data[offset:]

    def __getitem__(self, idx):
        row = self.data[idx]
        return (row[:-1].astype(np.float32), row[-1:].astype(np.float32))

    def __len__(self):
        return len(self.data)


class WMT14(Dataset):
    """reference: text/datasets/wmt14.py:44 (tgz with *src.dict /
    *trg.dict and {mode}/{mode} tab-separated bitext; <s>/<e> wrapping,
    UNK_IDX=2, sequences longer than 80 dropped)."""

    START, END, UNK_IDX = "<s>", "<e>", 2

    def __init__(self, data_file=None, mode="train", dict_size=-1,
                 download=True):
        assert mode.lower() in ("train", "test", "gen"), mode
        self.mode = mode.lower()
        self.data_file = _need_file(
            data_file, "WMT14",
            "wmt14.tgz with members *src.dict, *trg.dict and "
            "{train/train,test/test,gen/gen} bitext (src\\ttrg lines)")
        assert dict_size > 0, "dict_size should be set as positive number"
        self.dict_size = dict_size
        self._load_data()

    @staticmethod
    def _to_dict(f, size):
        d = {}
        for i, line in enumerate(f):
            if i >= size:
                break
            d[line.decode().strip()] = i
        return d

    def _load_data(self):
        self.src_ids, self.trg_ids, self.trg_ids_next = [], [], []
        with tarfile.open(self.data_file) as tf:
            src = [n for n in tf.getnames() if n.endswith("src.dict")]
            trg = [n for n in tf.getnames() if n.endswith("trg.dict")]
            assert len(src) == 1 and len(trg) == 1, (src, trg)
            self.src_dict = self._to_dict(tf.extractfile(src[0]),
                                          self.dict_size)
            self.trg_dict = self._to_dict(tf.extractfile(trg[0]),
                                          self.dict_size)
            wanted = f"{self.mode}/{self.mode}"
            for name in tf.getnames():
                if not name.endswith(wanted):
                    continue
                for line in tf.extractfile(name):
                    parts = line.decode().strip().split("\t")
                    if len(parts) != 2:
                        continue
                    sw = parts[0].split()
                    src_ids = [self.src_dict.get(w, self.UNK_IDX)
                               for w in [self.START] + sw + [self.END]]
                    tw = parts[1].split()
                    trg = [self.trg_dict.get(w, self.UNK_IDX) for w in tw]
                    if len(src_ids) > 80 or len(trg) > 80:
                        continue
                    self.src_ids.append(src_ids)
                    self.trg_ids.append([self.trg_dict[self.START]] + trg)
                    self.trg_ids_next.append(trg + [self.trg_dict[self.END]])

    def __getitem__(self, idx):
        return (np.array(self.src_ids[idx]), np.array(self.trg_ids[idx]),
                np.array(self.trg_ids_next[idx]))

    def __len__(self):
        return len(self.src_ids)

    def get_dict(self, reverse=False):
        if reverse:
            return ({v: k for k, v in self.src_dict.items()},
                    {v: k for k, v in self.trg_dict.items()})
        return self.src_dict, self.trg_dict


class WMT16(Dataset):
    """reference: text/datasets/wmt16.py:39 (tar with wmt16/{train,test,
    val} tab-separated en\\tde lines; dict built from the train split by
    frequency with <s>/<e>/<unk> heads, cached as {lang}_{size}.dict)."""

    START_MARK, END_MARK, UNK_MARK = "<s>", "<e>", "<unk>"

    def __init__(self, data_file=None, mode="train", src_dict_size=-1,
                 trg_dict_size=-1, lang="en", download=True,
                 dict_cache_dir=None):
        assert mode.lower() in ("train", "test", "val"), mode
        self.mode = mode.lower()
        self.data_file = _need_file(
            data_file, "WMT16",
            "wmt16.tar with members wmt16/{train,test,val} "
            "(en\\tde lines)")
        self.lang = lang
        assert src_dict_size > 0 and trg_dict_size > 0, \
            "dict_size should be set as positive number"
        self.src_dict_size = src_dict_size
        self.trg_dict_size = trg_dict_size
        # cache under a DATA_HOME-style dir (reference parity: the
        # archive's mount may be read-only), keyed by the archive's
        # identity so a different/modified archive never reuses a stale
        # vocabulary
        self._cache = dict_cache_dir or os.environ.get(
            "PADDLE_TPU_DATA_HOME",
            os.path.join(os.path.expanduser("~"), ".cache", "paddle_tpu",
                         "wmt16"))
        os.makedirs(self._cache, exist_ok=True)
        st = os.stat(self.data_file)
        import hashlib
        self._archive_key = hashlib.sha1(
            f"{os.path.abspath(self.data_file)}:{st.st_size}:"
            f"{st.st_mtime_ns}".encode()).hexdigest()[:12]
        self.src_dict = self._load_dict(lang, src_dict_size)
        self.trg_dict = self._load_dict("de" if lang == "en" else "en",
                                        trg_dict_size)
        self._load_data()

    def _dict_path(self, lang, size):
        return os.path.join(
            self._cache, f"wmt16_{self._archive_key}_{lang}_{size}.dict")

    def _build_dict(self, path, size, lang):
        freq = collections.defaultdict(int)
        col = 0 if lang == "en" else 1
        with tarfile.open(self.data_file) as tf:
            for line in tf.extractfile("wmt16/train"):
                parts = line.decode().strip().split("\t")
                if len(parts) != 2:
                    continue
                for w in parts[col].split():
                    freq[w] += 1
        with open(path + ".tmp", "w") as f:
            f.write(f"{self.START_MARK}\n{self.END_MARK}\n{self.UNK_MARK}\n")
            for i, (w, _) in enumerate(
                    sorted(freq.items(), key=lambda x: x[1], reverse=True)):
                if i + 3 == size:
                    break
                f.write(w + "\n")
        os.replace(path + ".tmp", path)  # no partial cache on a crash

    def _load_dict(self, lang, size, reverse=False):
        path = self._dict_path(lang, size)
        # <= size: the build loop stops early when the corpus vocabulary
        # is smaller than dict_size, which is still a complete dict
        ok = (os.path.exists(path)
              and len(open(path).readlines()) <= size)
        if not ok:
            self._build_dict(path, size, lang)
        d = {}
        with open(path) as f:
            for i, line in enumerate(f):
                if reverse:
                    d[i] = line.strip()
                else:
                    d[line.strip()] = i
        return d

    def _load_data(self):
        start = self.src_dict[self.START_MARK]
        end = self.src_dict[self.END_MARK]
        unk = self.src_dict[self.UNK_MARK]
        src_col = 0 if self.lang == "en" else 1
        self.src_ids, self.trg_ids, self.trg_ids_next = [], [], []
        with tarfile.open(self.data_file) as tf:
            for line in tf.extractfile(f"wmt16/{self.mode}"):
                parts = line.decode().strip().split("\t")
                if len(parts) != 2:
                    continue
                sw = parts[src_col].split()
                tw = parts[1 - src_col].split()
                trg = [self.trg_dict.get(w, unk) for w in tw]
                self.src_ids.append(
                    [start] + [self.src_dict.get(w, unk) for w in sw]
                    + [end])
                self.trg_ids.append([start] + trg)
                self.trg_ids_next.append(trg + [end])

    def __getitem__(self, idx):
        return (np.array(self.src_ids[idx]), np.array(self.trg_ids[idx]),
                np.array(self.trg_ids_next[idx]))

    def __len__(self):
        return len(self.src_ids)

    def get_dict(self, lang, reverse=False):
        size = (self.src_dict_size if lang == self.lang
                else self.trg_dict_size)
        return self._load_dict(lang, size, reverse)
