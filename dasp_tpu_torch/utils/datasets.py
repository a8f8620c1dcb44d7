"""Dataset acquisition: resumable verified downloads and a named registry.

The port's copy of ``dasp_tpu/utils/datasets.py`` (standard library only),
kept so that the port loads nothing from the JAX package. A bare wget loop
neither survives an interrupted download, nor verifies what arrived, nor
remembers what was already checked. This module:

* :func:`fetch` — HTTP(S) download with **resume** (Range requests into a
  ``.partial`` file, atomic rename on completion), bounded retries with
  backoff, and optional sha256 / size verification.
* :func:`extract_zip` — safe zip extraction (rejects paths escaping the
  target directory) for archive datasets such as GuitarSet.
* ``DATASETS`` registry + :func:`acquire` / :func:`verify` — named
  datasets resolve to files, are fetched only when missing or corrupt,
  and a manifest cache (``.dasp_manifest.json``, the JAX package's format)
  records verified hashes so repeated runs skip re-hashing gigabytes.
* CLI: ``python -m dasp_tpu_torch.utils.datasets idmt-amps --root
  audio/amps``.

Everything is stdlib (urllib, zipfile, hashlib); no network is touched
unless a file is actually missing or fails verification, so offline
environments that pre-stage files never hit the wire.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
import urllib.error
import urllib.request
import zipfile
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "fetch",
    "extract_zip",
    "sha256_file",
    "DatasetSpec",
    "DATASETS",
    "acquire",
    "verify",
    "DownloadError",
]

_CHUNK = 1 << 18  # 256 KiB read granularity
_MANIFEST_NAME = ".dasp_manifest.json"


class DownloadError(RuntimeError):
    """A download failed after exhausting retries, or verification failed
    in a way re-downloading did not fix."""


def sha256_file(path: str, chunk: int = _CHUNK) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def _verify_file(path: str, sha256: Optional[str], size: Optional[int]) -> bool:
    if not os.path.exists(path):
        return False
    if size is not None and os.path.getsize(path) != size:
        return False
    if sha256 is not None and sha256_file(path) != sha256.lower():
        return False
    return True


def _open_url(url: str, start: int, timeout: float):
    """Open ``url`` for reading, asking the server to start at byte
    ``start``. Returns (response, resumed): ``resumed`` is False when the
    server ignored the Range header and is sending the whole body."""
    req = urllib.request.Request(url, headers={"User-Agent": "dasp-tpu/1.0"})
    if start > 0:
        req.add_header("Range", f"bytes={start}-")
    resp = urllib.request.urlopen(req, timeout=timeout)
    resumed = start > 0 and getattr(resp, "status", resp.getcode()) == 206
    return resp, resumed


def fetch(
    url: str,
    dest: str,
    *,
    sha256: Optional[str] = None,
    size: Optional[int] = None,
    retries: int = 3,
    timeout: float = 30.0,
    backoff: float = 1.5,
    progress: Optional[Callable[[int, Optional[int]], None]] = None,
) -> str:
    """Download ``url`` to ``dest``, resuming a previous partial transfer.

    The transfer streams into ``dest + ".partial"``; on a clean finish
    (and passing verification, when ``sha256``/``size`` are given) it is
    atomically renamed to ``dest``. A pre-existing valid ``dest`` is kept
    untouched and returned immediately. On interruption the ``.partial``
    stays behind and the next call issues an HTTP Range request from its
    current length, where a wget loop would restart from byte 0.

    ``progress`` (if given) is called with (bytes_done, total_or_None)
    after each chunk. Raises :class:`DownloadError` on failure.
    """
    if _verify_file(dest, sha256, size):
        return dest

    part = dest + ".partial"
    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)

    last_err: Optional[BaseException] = None
    for attempt in range(max(1, retries)):
        if attempt:
            time.sleep(backoff * (2 ** (attempt - 1)))
        start = os.path.getsize(part) if os.path.exists(part) else 0
        try:
            resp, resumed = _open_url(url, start, timeout)
        except (urllib.error.URLError, OSError, ValueError) as e:
            last_err = e
            continue
        mode = "ab" if (start and resumed) else "wb"
        done = start if mode == "ab" else 0
        total: Optional[int] = None
        clen = resp.headers.get("Content-Length") if hasattr(resp, "headers") else None
        if clen is not None:
            try:
                total = done + int(clen)
            except ValueError:
                total = None
        try:
            with resp, open(part, mode) as out:
                while True:
                    block = resp.read(_CHUNK)
                    if not block:
                        break
                    out.write(block)
                    done += len(block)
                    if progress is not None:
                        progress(done, total)
        except (urllib.error.URLError, OSError) as e:
            last_err = e
            continue  # keep the .partial; next attempt resumes from it
        got = os.path.getsize(part)
        # http.client returns a short body silently when the connection
        # drops mid-stream (read(amt) compat behavior) — detect truncation
        # against the advertised length and resume, don't restart
        expected = size if size is not None else total
        if expected is not None and got < expected:
            last_err = DownloadError(f"{url}: connection dropped at {got}/{expected} bytes")
            continue  # .partial kept; next attempt sends Range: bytes={got}-
        # transfer finished — verify before promoting
        if size is not None and got != size:
            last_err = DownloadError(f"{url}: size mismatch (got {got}, want {size})")
            os.remove(part)  # server sent the wrong object: start over
            continue
        if sha256 is not None and sha256_file(part) != sha256.lower():
            last_err = DownloadError(f"{url}: sha256 mismatch")
            os.remove(part)
            continue
        os.replace(part, dest)
        return dest

    raise DownloadError(
        f"failed to download {url} after {retries} attempt(s): {last_err}\n"
        f"If this environment has no network access, place the file at "
        f"{dest} manually and re-run."
    )


def extract_zip(archive: str, dest_dir: str, *, remove_archive: bool = False) -> List[str]:
    """Extract ``archive`` into ``dest_dir`` (e.g. GuitarSet's
    ``audio_mono-mic.zip``), refusing member paths that escape
    ``dest_dir``. Returns the extracted paths."""
    out: List[str] = []
    dest_dir = os.path.abspath(dest_dir)
    with zipfile.ZipFile(archive) as zf:
        for info in zf.infolist():
            target = os.path.abspath(os.path.join(dest_dir, info.filename))
            if not (target + os.sep).startswith(dest_dir + os.sep) and target != dest_dir:
                raise DownloadError(f"{archive}: unsafe member path {info.filename!r}")
            zf.extract(info, dest_dir)
            if not info.is_dir():
                out.append(target)
    if remove_archive:
        os.remove(archive)
    return out


# ---------------------------------------------------------------------------
# Registry


@dataclass(frozen=True)
class DatasetSpec:
    """One named dataset: a list of (relative_path, url) files, optional
    per-file sha256/size, and optional archives to extract after fetch."""

    name: str
    files: Tuple[Tuple[str, str], ...]  # (relative dest path, url)
    sha256: Dict[str, str] = field(default_factory=dict)   # rel path -> hex digest
    sizes: Dict[str, int] = field(default_factory=dict)    # rel path -> bytes
    archives: Tuple[str, ...] = ()  # rel paths in `files` that are zips to extract
    notes: str = ""


_IDMT_BASE = "https://csteinmetz1.github.io/sounds/assets/amps/"
_IDMT_FILES = (
    "idmt-rock-input-varying-gain.wav",
    "idmt-rock-clean1-65twin-reverb.wav",
    "idmt-rock-clean2-jazz-amp-120.wav",
    "idmt-rock-crunch1-orange-dual-terror.wav",
    "idmt-rock-crunch2-british-blue-tube-30tb.wav",
    "idmt-rock-high-gain1-brit-8000.wav",
    "idmt-rock-high-gain2-mesa-triple-rectifier.wav",
)

DATASETS: Dict[str, DatasetSpec] = {
    # the six IDMT amp responses + shared input used by virtual_analog
    "idmt-amps": DatasetSpec(
        name="idmt-amps",
        files=tuple((f, _IDMT_BASE + f) for f in _IDMT_FILES),
        notes="IDMT-SMT-Audio-Effects amp recordings (virtual analog example)",
    ),
    # GuitarSet mono-mic audio, the corpus for the other trainers
    "guitarset-mono-mic": DatasetSpec(
        name="guitarset-mono-mic",
        files=(("audio_mono-mic.zip",
                "https://zenodo.org/records/3371780/files/audio_mono-mic.zip"),),
        archives=("audio_mono-mic.zip",),
        notes="GuitarSet audio_mono-mic (style transfer / auto-EQ / blind estimation)",
    ),
}


def _manifest_path(root: str) -> str:
    return os.path.join(root, _MANIFEST_NAME)


def _load_manifest(root: str) -> Dict[str, Dict[str, object]]:
    try:
        with open(_manifest_path(root)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _save_manifest(root: str, manifest: Dict[str, Dict[str, object]]) -> None:
    tmp = _manifest_path(root) + ".tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
        os.replace(tmp, _manifest_path(root))
    except OSError:
        pass  # read-only dataset dir: cache is an optimization only


def _manifest_entry(path: str) -> Dict[str, object]:
    st = os.stat(path)
    return {"size": st.st_size, "mtime": st.st_mtime, "sha256": sha256_file(path)}


def verify(name: str, root: str, *, rehash: bool = False) -> Dict[str, bool]:
    """Check which of dataset ``name``'s files are present (and hash-valid
    where the registry pins a digest). Uses the manifest cache to skip
    re-hashing unchanged files unless ``rehash``. Returns
    {relative_path: ok}."""
    spec = DATASETS[name]
    manifest = _load_manifest(root)
    status: Dict[str, bool] = {}
    for rel, _url in spec.files:
        path = os.path.join(root, rel)
        if not os.path.exists(path):
            status[rel] = False
            continue
        want = spec.sha256.get(rel)
        if want is None:
            status[rel] = (spec.sizes.get(rel) is None
                           or os.path.getsize(path) == spec.sizes[rel])
            continue
        cached = manifest.get(rel)
        st = os.stat(path)
        if (not rehash and cached
                and cached.get("size") == st.st_size
                and cached.get("mtime") == st.st_mtime):
            status[rel] = cached.get("sha256") == want.lower()
        else:
            entry = _manifest_entry(path)
            manifest[rel] = entry
            status[rel] = entry["sha256"] == want.lower()
    _save_manifest(root, manifest)
    return status


def acquire(
    name: str,
    root: str,
    *,
    files: Optional[Sequence[str]] = None,
    offline: bool = False,
    retries: int = 3,
    timeout: float = 30.0,
    progress: Optional[Callable[[str, int, Optional[int]], None]] = None,
    base_url: Optional[str] = None,
) -> List[str]:
    """Ensure dataset ``name`` is present under ``root``; fetch (resumably)
    whatever is missing or fails verification, extract registered
    archives, and return the local paths of the requested files.

    ``files`` restricts acquisition to a subset of relative paths (e.g.
    one amp pair instead of all six). ``offline=True`` never touches the
    network: present files are returned, missing ones raise with manual
    instructions. ``base_url`` overrides every file's URL prefix (used by
    tests to point at a local server, and by mirrors)."""
    spec = DATASETS[name]
    wanted = list(files) if files is not None else [rel for rel, _ in spec.files]
    url_of = dict(spec.files)
    missing_urls = [rel for rel in wanted if rel not in url_of]
    if missing_urls:
        raise KeyError(f"{name}: unknown files {missing_urls}; registry has "
                       f"{[rel for rel, _ in spec.files]}")

    out: List[str] = []
    for rel in wanted:
        path = os.path.join(root, rel)
        url = url_of[rel]
        if base_url is not None:
            url = base_url.rstrip("/") + "/" + rel
        ok = _verify_file(path, spec.sha256.get(rel), spec.sizes.get(rel))
        if not ok:
            if offline:
                raise DownloadError(
                    f"{name}: {rel} is missing/invalid under {root} and "
                    f"offline=True; download {url} to {path} manually.")
            fetch(url, path,
                  sha256=spec.sha256.get(rel), size=spec.sizes.get(rel),
                  retries=retries, timeout=timeout,
                  progress=(None if progress is None
                            else (lambda d, t, _rel=rel: progress(_rel, d, t))))
        out.append(path)
        if rel in spec.archives:
            extract_zip(path, root)
    # refresh the manifest for everything we just validated/downloaded
    manifest = _load_manifest(root)
    for rel in wanted:
        p = os.path.join(root, rel)
        if os.path.exists(p):
            manifest[rel] = _manifest_entry(p)
    _save_manifest(root, manifest)
    return out


def _cli(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="Fetch a registered dataset (resumable, verified).")
    parser.add_argument("dataset", choices=sorted(DATASETS),
                        help="registered dataset name")
    parser.add_argument("--root", default="data", help="destination directory")
    parser.add_argument("--files", nargs="*", default=None,
                        help="subset of relative paths (default: all)")
    parser.add_argument("--offline", action="store_true",
                        help="never touch the network; fail if files missing")
    parser.add_argument("--verify", action="store_true",
                        help="only report per-file status, do not download")
    args = parser.parse_args(argv)

    if args.verify:
        status = verify(args.dataset, args.root)
        for rel, ok in status.items():
            print(f"{'ok     ' if ok else 'MISSING'} {rel}")
        return 0 if all(status.values()) else 1

    def report(rel: str, done: int, total: Optional[int]) -> None:
        pct = f"{100.0 * done / total:5.1f}%" if total else f"{done >> 20} MiB"
        print(f"\r{rel}: {pct}", end="", flush=True)

    paths = acquire(args.dataset, args.root, files=args.files,
                    offline=args.offline, progress=report)
    print()
    for p in paths:
        print(p)
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via CLI test
    raise SystemExit(_cli())
