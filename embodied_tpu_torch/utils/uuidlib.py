"""Compact 16-byte UUIDs with base62 string form.

A copy of embodied_tpu/utils/uuidlib.py.

Capability parity: elements.UUID as used for replay chunk/step ids
(the reference's embodied/core/chunk.py:30-33, core/replay.py:90-91).
The string form sorts consistently with creation when prefixed by timestamp
in chunk filenames; equality and hashing work on the raw bytes.
"""

import secrets
import string

_ALPHABET = string.digits + string.ascii_uppercase + string.ascii_lowercase
_BASE = len(_ALPHABET)  # 62
_NBYTES = 16
_STRLEN = 22  # ceil(128 / log2(62))


class UUID:

  __slots__ = ('_bytes',)

  def __init__(self, value=None):
    if value is None:
      self._bytes = secrets.token_bytes(_NBYTES)
    elif isinstance(value, UUID):
      self._bytes = value._bytes
    elif isinstance(value, bytes):
      assert len(value) == _NBYTES, len(value)
      self._bytes = value
    elif isinstance(value, str):
      self._bytes = _decode(value)
    else:
      raise TypeError(type(value))

  def __bytes__(self):
    return self._bytes

  def __str__(self):
    return _encode(self._bytes)

  def __repr__(self):
    return f'UUID({self})'

  def __eq__(self, other):
    if isinstance(other, UUID):
      return self._bytes == other._bytes
    if isinstance(other, bytes):
      return self._bytes == other
    if isinstance(other, str):
      return str(self) == other
    return NotImplemented

  def __hash__(self):
    return hash(self._bytes)

  def __lt__(self, other):
    return self._bytes < bytes(UUID(other))


def _encode(raw):
  number = int.from_bytes(raw, 'big')
  chars = []
  for _ in range(_STRLEN):
    number, rem = divmod(number, _BASE)
    chars.append(_ALPHABET[rem])
  return ''.join(reversed(chars))


def _decode(text):
  assert len(text) == _STRLEN, (text, len(text))
  number = 0
  for char in text:
    number = number * _BASE + _ALPHABET.index(char)
  return number.to_bytes(_NBYTES, 'big')
