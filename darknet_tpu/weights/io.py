"""Byte-exact `.weights` reader/writer.

File layout (reference `parser.cpp:1590-1876`):

    int32 major, int32 minor, int32 revision
    uint64 seen                      # images seen, drives LR-schedule resume
    then, for each layer in topological order:
      convolutional (not weight-shared):
          biases[n]
          if batch_normalize: scales[n], rolling_mean[n], rolling_variance[n]
          weights[(c/groups) * n * size * size]      # (n, c/g, kh, kw) order
      connected:
          biases[outputs], weights[outputs*inputs]   # (outputs, inputs) order
          if batch_normalize: scales, rolling_mean, rolling_variance [outputs]
      batchnorm: biases[c], scales[c], rolling_mean[c], rolling_variance[c]
      local:     biases[outputs], weights[size*size*c*n*out_h*out_w]
    all float32 little-endian; EOF mid-stream is tolerated (partial backbones
    for transfer learning, parser.cpp:1837-1838).

In-memory parameter convention (the "params PyTree"): a list with one dict
per layer; convolution weights are stored HWIO
``(kh, kw, c/groups, n)`` and converted to/from the darknet OIHW order here,
at the serialization boundary only.  Connected weights are stored
``(inputs, outputs)`` (so `y = x @ w + b`).
"""

from __future__ import annotations

import struct

import numpy as np

from darknet_tpu.version import WEIGHTS_VERSION


def conv_w_to_darknet(w: np.ndarray) -> np.ndarray:
    """(kh, kw, c/g, n) HWIO -> flat darknet (n, c/g, kh, kw)."""
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))).ravel()


def conv_w_from_darknet(flat: np.ndarray, kh: int, kw: int, cg: int,
                        n: int) -> np.ndarray:
    """flat darknet (n, c/g, kh, kw) -> (kh, kw, c/g, n) HWIO."""
    return np.ascontiguousarray(
        np.transpose(flat.reshape(n, cg, kh, kw), (2, 3, 1, 0)))


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def floats(self, count: int) -> np.ndarray | None:
        """Read `count` float32; None once the stream is exhausted.

        A short read returns the zero-padded prefix with a warning, matching
        the reference's fread + warning behaviour.
        """
        nbytes = count * 4
        if self.pos >= len(self.data):
            return None
        chunk = self.data[self.pos: self.pos + nbytes]
        self.pos += len(chunk)
        arr = np.frombuffer(chunk, dtype="<f4")
        if arr.size < count:
            import warnings
            warnings.warn(
                f"Unexpected end of weights-file (wanted {count} floats, "
                f"got {arr.size})")
            arr = np.concatenate(
                [arr, np.zeros(count - arr.size, dtype=np.float32)])
        return arr.astype(np.float32)

    @property
    def eof(self) -> bool:
        return self.pos >= len(self.data)


def load_weights(graph, path, cutoff: int | None = None):
    """Read a .weights file into (params, seen, version).

    `params[i]` is a dict for layer i (possibly empty).  `graph` is a
    `darknet_tpu.graph.builder.Graph`.
    """
    with open(path, "rb") as f:
        data = f.read()
    return load_weights_bytes(graph, data, cutoff=cutoff)


def load_weights_bytes(graph, data: bytes, cutoff: int | None = None):
    major, minor, revision = struct.unpack("<iii", data[:12])
    (seen,) = struct.unpack("<Q", data[12:20])
    r = _Reader(data[20:])
    transpose = (major > 1000) or (minor > 1000)

    n_layers = len(graph.layers) if cutoff is None \
        else min(len(graph.layers), cutoff)
    params: list[dict] = [dict() for _ in graph.layers]

    for i in range(n_layers):
        l = graph.layers[i]
        if l.dontload:
            continue
        if l.kind == "convolutional" and l.share_index is None:
            p = {}
            b = r.floats(l.n)
            if b is None:
                break
            p["b"] = b
            if l.batch_normalize and not l.dontloadscales:
                p["scales"] = r.floats(l.n)
                p["mean"] = r.floats(l.n)
                p["var"] = r.floats(l.n)
                if p["var"] is None:
                    params[i] = {k: v for k, v in p.items() if v is not None}
                    break
            flat = r.floats(l.nweights)
            if flat is None:
                params[i] = {k: v for k, v in p.items() if v is not None}
                break
            p["w"] = conv_w_from_darknet(
                flat, l.size, l.size, l.c // l.groups, l.n)
            params[i] = p
        elif l.kind == "connected":
            p = {}
            p["b"] = r.floats(l.outputs)
            flat = r.floats(l.outputs * l.inputs)
            if flat is None:
                break
            w = flat.reshape(l.outputs, l.inputs)
            if transpose:
                # ancient format stored (inputs, outputs); reference
                # TransposeMat converts in place (parser.cpp:1650-1663)
                w = flat.reshape(l.inputs, l.outputs).T
            p["w"] = np.ascontiguousarray(w.T)      # (inputs, outputs)
            if l.batch_normalize and not l.dontloadscales:
                p["scales"] = r.floats(l.outputs)
                p["mean"] = r.floats(l.outputs)
                p["var"] = r.floats(l.outputs)
            params[i] = {k: v for k, v in p.items() if v is not None}
        elif l.kind == "batchnorm":
            p = {
                "b": r.floats(l.c),
                "scales": r.floats(l.c),
                "mean": r.floats(l.c),
                "var": r.floats(l.c),
            }
            params[i] = {k: v for k, v in p.items() if v is not None}
        elif l.kind == "local":
            locations = l.out_w * l.out_h
            size = l.size * l.size * l.c * l.n * locations
            p = {"b": r.floats(l.outputs)}
            flat = r.floats(size)
            if flat is not None:
                p["w"] = flat.reshape(locations, l.n, l.size * l.size * l.c)
            params[i] = {k: v for k, v in p.items() if v is not None}
        if r.eof:
            break

    return params, seen, (major, minor, revision)


def save_weights(graph, params, path, seen: int = 0,
                 cutoff: int | None = None) -> None:
    data = save_weights_bytes(graph, params, seen=seen, cutoff=cutoff)
    with open(path, "wb") as f:
        f.write(data)


def save_weights_bytes(graph, params, seen: int = 0,
                       cutoff: int | None = None) -> bytes:
    out = bytearray()
    major, minor, patch = WEIGHTS_VERSION
    out += struct.pack("<iii", major, minor, patch)
    out += struct.pack("<Q", int(seen))

    def w32(a):
        out.extend(np.asarray(a, dtype="<f4").tobytes())

    n_layers = len(graph.layers) if cutoff is None \
        else min(len(graph.layers), cutoff)
    for i in range(n_layers):
        l = graph.layers[i]
        p = params[i]
        if l.kind == "convolutional" and l.share_index is None:
            w32(p["b"])
            if l.batch_normalize:
                w32(p["scales"])
                w32(p["mean"])
                w32(p["var"])
            w32(conv_w_to_darknet(np.asarray(p["w"])))
        elif l.kind == "connected":
            w32(p["b"])
            w32(np.asarray(p["w"]).T)               # back to (outputs, inputs)
            if l.batch_normalize:
                w32(p["scales"])
                w32(p["mean"])
                w32(p["var"])
        elif l.kind == "batchnorm":
            w32(p["b"])
            w32(p["scales"])
            w32(p["mean"])
            w32(p["var"])
        elif l.kind == "local":
            w32(p["b"])
            w32(np.asarray(p["w"]))
    return bytes(out)
