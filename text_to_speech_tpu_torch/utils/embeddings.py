"""Speaker-embedding storage and selection.

Counterpart of ``text_to_speech_tpu/utils/embeddings.py``, on numpy.
Embeddings are stored as a table ``{'embedding': (N, D) array, ...metadata
columns (e.g. 'id' / 'speaker': (N,) lists)}`` in .npy, .npz or .pkl files,
which both packages read and write alike; .csv (``pandas``) and .h5
(``h5py``) are imported when used and raise ImportError on a host without
them.
"""

import os

import numpy as np

from .distances import distance


def embeddings_to_np(embeddings, col = 'embedding', dtype = np.float32):
    """Embeddings as a (N, D) float array, from an array, a list, a table
    dict, a DataFrame (`col` column), a string ('[1, 2]' or '[[...], [...]]',
    as csv cells hold them) or a file `load_embeddings` reads."""
    if isinstance(embeddings, str):
        text = embeddings.strip()
        if text.startswith('[['):
            rows = [r.strip(' ,') for r in text[1:-1].split(']')]
            return np.stack([embeddings_to_np(r + ']', dtype = dtype)
                             for r in rows if r])
        if text.startswith('['):
            sep = ',' if ',' in text else None
            values = [v for v in text[1:-1].split(sep) if v.strip()]
            return np.array([float(v) for v in values], dtype)
        if os.path.isfile(embeddings):
            return embeddings_to_np(load_embeddings(embeddings),
                                    col = col, dtype = dtype)
        raise ValueError('invalid embedding string {!r}'.format(embeddings[:50]))
    if isinstance(embeddings, dict):
        return np.asarray(embeddings[col], dtype)
    if hasattr(embeddings, 'columns'):                  # DataFrame
        return np.stack([embeddings_to_np(e, dtype = dtype)
                         for e in embeddings[col].values])
    return np.atleast_2d(np.asarray(embeddings, dtype))


def aggregate_embeddings(table, column = 'id', embedding_col = 'embedding',
                         aggregation_name = 'speaker_embedding', mode = 'mean'):
    """Group the table's embeddings by `column` and aggregate each group
    (mode: 'mean', 'sum' or a callable): every row gains `aggregation_name`,
    its group's aggregate."""
    emb = embeddings_to_np(table, col = embedding_col)
    if hasattr(table, 'columns'):
        keys = table[column].values.tolist()
    else:
        keys = list(table[column])
    agg_fn = mode if callable(mode) else {
        'mean': lambda x: x.mean(0), 'sum': lambda x: x.sum(0)}[mode]
    groups = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    per_key = {k: agg_fn(emb[idx]) for k, idx in groups.items()}
    aggregated = np.stack([per_key[k] for k in keys])
    if hasattr(table, 'columns'):
        table = table.copy()
        table[aggregation_name] = list(aggregated)
        return table
    return {** table, aggregation_name: aggregated}


def get_embeddings_with_ids(embeddings, assignment, ids):
    """The rows of `(embeddings, assignment)` whose assignment is in `ids`."""
    embeddings, assignment = np.asarray(embeddings), np.asarray(assignment)
    mask = np.isin(assignment, np.asarray(ids))
    return embeddings[mask], assignment[mask]


def save_embeddings(filename, embeddings, ** metadata):
    """Save an (N, D) array (and aligned metadata columns) to
    .npz / .npy / .csv / .pkl / .h5; a .npy with metadata becomes a .npz."""
    embeddings = np.asarray(embeddings)
    ext = os.path.splitext(filename)[1].lower()
    d = os.path.dirname(filename)
    if d: os.makedirs(d, exist_ok = True)

    if ext == '.npy' and not metadata:
        np.save(filename, embeddings)
    elif ext in ('.npz', '.npy'):
        if ext == '.npy': filename = filename[:-4] + '.npz'
        np.savez(filename, embedding = embeddings,
                 ** {k: np.asarray(v) for k, v in metadata.items()})
    elif ext == '.csv':
        import pandas as pd
        df = pd.DataFrame({
            'embedding': [' '.join(map(str, e)) for e in embeddings], ** metadata
        })
        df.to_csv(filename, index = False)
    elif ext in ('.pkl', '.pickle'):
        import pickle
        with open(filename, 'wb') as f:
            pickle.dump({'embedding': embeddings, ** metadata}, f)
    elif ext in ('.h5', '.hdf5'):
        import h5py
        with h5py.File(filename, 'w') as file:
            file.create_dataset('embedding', data = embeddings)
            for key, value in metadata.items():
                file.create_dataset(key, data = _h5_column(value))
    else:
        raise ValueError('Unsupported embeddings format: {}'.format(ext))
    return filename


def _h5_column(values):
    arr = np.asarray(values)
    # h5py stores utf-8 byte strings, not unicode object arrays
    if arr.dtype.kind in ('U', 'O'):
        arr = np.asarray([str(v).encode('utf-8') for v in values])
    return arr


def load_embeddings(filename):
    """Embeddings saved by `save_embeddings` → {'embedding': (N, D), ...metadata}."""
    ext = os.path.splitext(filename)[1].lower()
    if not os.path.exists(filename) and ext == '.npy' and os.path.exists(filename[:-4] + '.npz'):
        filename, ext = filename[:-4] + '.npz', '.npz'

    if ext == '.npy':
        return {'embedding': np.load(filename)}
    if ext == '.npz':
        with np.load(filename, allow_pickle = True) as data:
            return {k: data[k] for k in data.files}
    if ext == '.csv':
        import pandas as pd
        df = pd.read_csv(filename)
        out = {
            'embedding': np.stack([
                np.array(e.split(), dtype = np.float64) for e in df['embedding']
            ]).astype(np.float32)
        }
        for col in df.columns:
            if col != 'embedding': out[col] = df[col].to_numpy()
        return out
    if ext in ('.pkl', '.pickle'):
        import pickle
        with open(filename, 'rb') as f:
            return pickle.load(f)
    if ext in ('.h5', '.hdf5'):
        import h5py
        out = {}
        with h5py.File(filename, 'r') as file:
            for key in file:
                value = file[key][()]
                if isinstance(value, np.ndarray) and value.dtype.kind == 'S':
                    value = np.asarray([v.decode('utf-8') for v in value])
                out[key] = value
        return out
    raise ValueError('Unsupported embeddings format: {}'.format(ext))


def select_embedding(embeddings, mode = 'random', *, label = None,
                     label_column = None, seed = None, ** kwargs):
    """One (D,) embedding of a table, an array or a file.

    mode: 'random' | 'mean' | 'label' | int (row index) | callable(vectors)
    → (D,); `label` keeps the rows it matches first (in any metadata column,
    or in `label_column`), and 'label' is the mean of those rows.  (The JAX
    package lists 'label' among the modes but refuses it: there it is
    'mean' with a `label`.)"""
    if mode == 'label':
        if label is None:
            raise ValueError("mode 'label' needs a `label`")
        mode = 'mean'
    if isinstance(embeddings, str):
        embeddings = load_embeddings(embeddings)
    if isinstance(embeddings, np.ndarray):
        embeddings = {'embedding': embeddings if embeddings.ndim == 2 else embeddings[None]}

    table = dict(embeddings)
    vectors = np.asarray(table['embedding'])

    if label is not None:
        columns = [label_column] if label_column else [
            c for c in table if c != 'embedding'
        ]
        mask = np.zeros(len(vectors), dtype = bool)
        for col in columns:
            if col in table:
                mask |= np.asarray(table[col]) == label
        if not mask.any():
            raise ValueError('No embedding with label {!r}'.format(label))
        vectors = vectors[mask]

    if callable(mode):
        return mode(vectors)
    if mode == 'mean':
        return vectors.mean(axis = 0)
    if mode == 'random':
        rng = np.random.RandomState(seed)
        return vectors[rng.randint(len(vectors))]
    if isinstance(mode, (int, np.integer)):
        return vectors[int(mode)]
    raise ValueError('Unknown selection mode: {!r}'.format(mode))


def compute_centroids(embeddings, labels):
    """The mean embedding of each label → (sorted unique labels, centroids (L, D))."""
    embeddings = np.asarray(embeddings)
    labels = np.asarray(labels)
    unique = sorted(set(labels.tolist()))
    centroids = np.stack([
        embeddings[labels == u].mean(axis = 0) for u in unique
    ])
    return unique, centroids


def get_closest_centroid(embedding, centroids, method = 'euclidean'):
    dists = distance(embedding, centroids, method = method, as_matrix = True)
    return int(np.argmin(np.asarray(dists), axis = -1)[0])
