"""Filesystem path wrapper with optional GCS support.

A copy of embodied_tpu/utils/path.py.

Capability parity: elements.Path (GCS-aware, the reference's embodied/jax/agent.py:298).
GCS access is gated on google-cloud-storage availability; local paths use pathlib.
"""

import contextlib
import glob as globlib
import os
import shutil


class Path:

  def __new__(cls, path):
    path = str(path)
    if path.startswith('gs://'):
      return super().__new__(GCSPath)
    return super().__new__(LocalPath)

  def __init__(self, path):
    self._path = str(path)

  def __str__(self):
    return self._path

  def __repr__(self):
    return f'Path({self._path})'

  def __fspath__(self):
    return self._path

  def __truediv__(self, other):
    sep = '' if self._path.endswith('/') else '/'
    return Path(f'{self._path}{sep}{other}')

  def __eq__(self, other):
    return str(self) == str(other)

  def __lt__(self, other):
    return str(self) < str(other)

  def __hash__(self):
    return hash(self._path)

  @property
  def parent(self):
    return Path(os.path.dirname(self._path.rstrip('/')) or '/')

  @property
  def name(self):
    return os.path.basename(self._path.rstrip('/'))

  @property
  def stem(self):
    name = self.name
    return name.rsplit('.', 1)[0] if '.' in name else name

  @property
  def suffix(self):
    name = self.name
    return '.' + name.rsplit('.', 1)[1] if '.' in name else ''


class LocalPath(Path):

  def __init__(self, path):
    path = os.path.expanduser(str(path))
    super().__init__(path)

  def exists(self):
    return os.path.exists(self._path)

  def is_dir(self):
    return os.path.isdir(self._path)

  def is_file(self):
    return os.path.isfile(self._path)

  def mkdir(self):
    os.makedirs(self._path, exist_ok=True)
    return self

  def glob(self, pattern):
    for match in sorted(globlib.glob(os.path.join(self._path, pattern))):
      yield Path(match)

  def read_bytes(self):
    with open(self._path, 'rb') as f:
      return f.read()

  def read_text(self):
    with open(self._path, 'r') as f:
      return f.read()

  def write_bytes(self, data):
    self._atomic_write(data, 'wb')

  def write_text(self, text):
    self._atomic_write(text, 'w')

  def _atomic_write(self, data, mode):
    tmp = self._path + '.tmp'
    with open(tmp, mode) as f:
      f.write(data)
    os.replace(tmp, self._path)

  @contextlib.contextmanager
  def open(self, mode='r'):
    with open(self._path, mode) as f:
      yield f

  def remove(self):
    if os.path.isdir(self._path):
      shutil.rmtree(self._path)
    elif os.path.exists(self._path):
      os.remove(self._path)

  def copy(self, dest):
    dest = Path(dest)
    if os.path.isdir(self._path):
      shutil.copytree(self._path, str(dest), dirs_exist_ok=True)
    else:
      shutil.copy(self._path, str(dest))


class GCSPath(Path):
  """GCS paths via google-cloud-storage when available."""

  def _bucket_blob(self):
    try:
      from google.cloud import storage
    except ImportError:
      raise RuntimeError(
          'gs:// paths require google-cloud-storage, which is unavailable')
    without = self._path[len('gs://'):]
    bucket_name, _, blob_name = without.partition('/')
    client = storage.Client()
    return client.bucket(bucket_name), blob_name

  def exists(self):
    bucket, name = self._bucket_blob()
    return bucket.blob(name).exists()

  def mkdir(self):
    return self  # GCS has no directories.

  def read_bytes(self):
    bucket, name = self._bucket_blob()
    return bucket.blob(name).download_as_bytes()

  def read_text(self):
    return self.read_bytes().decode()

  def write_bytes(self, data):
    bucket, name = self._bucket_blob()
    bucket.blob(name).upload_from_string(data)

  def write_text(self, text):
    self.write_bytes(text.encode())

  def glob(self, pattern):
    import fnmatch
    bucket, prefix = self._bucket_blob()
    for blob in bucket.list_blobs(prefix=prefix.rstrip('/') + '/'):
      if fnmatch.fnmatch(blob.name.split('/')[-1], pattern):
        yield Path(f'gs://{bucket.name}/{blob.name}')

  def remove(self):
    bucket, name = self._bucket_blob()
    bucket.blob(name).delete()
