"""NGram: sliding time-windows over consecutive rows within a row group
(the port's own copy of ``petastorm_tpu/ngram.py``).

- rows are sorted by ``timestamp_field`` within a row group; windows never
  span row groups (sequence length is bounded by row-group size);
- a window is rejected when any two consecutive timestamps differ by more
  than ``delta_threshold``;
- ``timestamp_overlap=False`` makes accepted windows share no timestamps
  (stride = window length instead of 1).

``make_reader(schema_fields=NGram(...))`` yields one ``{offset:
namedtuple}`` window per item, and ``torch_utils.batcher`` collates windows
to ``[B, T, ...]`` arrays, the shape the sequence encoder consumes.
"""

from __future__ import annotations

from petastorm_tpu_torch.schema.unischema import UnischemaField, match_unischema_fields


class NGram:
    """A window spec: ``fields`` maps relative offset → list of fields wanted
    at that offset (as :class:`UnischemaField` or name/regex strings)."""

    def __init__(self, fields, delta_threshold, timestamp_field,
                 timestamp_overlap=True):
        if not isinstance(fields, dict) or not fields:
            raise ValueError("fields must be a non-empty {offset: [field,...]} dict")
        for offset, field_list in fields.items():
            if not isinstance(offset, int):
                raise ValueError(f"Offsets must be ints, got {offset!r}")
            if not isinstance(field_list, (list, tuple)):
                raise ValueError(f"fields[{offset}] must be a list of fields")
        self._fields = {offset: list(field_list) for offset, field_list in fields.items()}
        self._delta_threshold = delta_threshold
        self._timestamp_field = timestamp_field
        self._timestamp_overlap = timestamp_overlap

    @property
    def fields(self):
        return self._fields

    @property
    def length(self):
        offsets = sorted(self._fields)
        return offsets[-1] - offsets[0] + 1

    @property
    def delta_threshold(self):
        return self._delta_threshold

    @property
    def timestamp_field(self):
        return self._timestamp_field

    @property
    def timestamp_overlap(self):
        return self._timestamp_overlap

    @property
    def timestamp_field_name(self):
        if isinstance(self._timestamp_field, UnischemaField):
            return self._timestamp_field.name
        return self._timestamp_field

    def resolve_regex_field_names(self, schema):
        """Expand any regex/name strings in the field lists against ``schema``
        (reference parity: regex resolution happens once the schema is known)."""
        resolved = {}
        for offset, field_list in self._fields.items():
            fields = []
            seen = set()
            for item in field_list:
                if isinstance(item, UnischemaField):
                    matches = [item]
                else:
                    matches = match_unischema_fields(schema, [item])
                    if not matches:
                        raise ValueError(
                            f"NGram field pattern {item!r} matched nothing at "
                            f"offset {offset}"
                        )
                for match in matches:
                    if match.name not in seen:
                        seen.add(match.name)
                        fields.append(match)
            resolved[offset] = fields
        self._fields = resolved

    def get_field_names_at_timestep(self, timestep):
        if timestep not in self._fields:
            return []
        return [f.name if isinstance(f, UnischemaField) else f
                for f in self._fields[timestep]]

    def get_field_names_at_all_timesteps(self):
        names = set()
        for timestep in self._fields:
            names.update(self.get_field_names_at_timestep(timestep))
        names.add(self.timestamp_field_name)
        return sorted(names)

    def get_schema_at_timestep(self, schema, timestep):
        """Schema view containing only the fields wanted at ``timestep``."""
        return schema.create_schema_view(
            [schema.fields[name] for name in self.get_field_names_at_timestep(timestep)
             if name in schema.fields]
        )

    def form_ngram(self, data, schema):
        """Assemble windows from one row group's decoded rows.

        ``data``: list of row dicts (each containing at least every field this
        NGram needs plus the timestamp field). Returns a list of
        ``{offset: row-dict}`` windows honoring delta_threshold and overlap.
        """
        ts_name = self.timestamp_field_name
        rows = sorted(data, key=lambda r: r[ts_name])
        offsets = sorted(self._fields)
        base_offset = offsets[0]
        window_len = self.length
        ngrams = []
        index = 0
        while index + window_len <= len(rows):
            window = rows[index:index + window_len]
            if self._window_ok(window, ts_name):
                ngram = {}
                for offset in offsets:
                    row = window[offset - base_offset]
                    wanted = self.get_field_names_at_timestep(offset)
                    ngram[offset] = {name: row[name] for name in wanted if name in row}
                ngrams.append(ngram)
                index += window_len if not self._timestamp_overlap else 1
            else:
                index += 1
        return ngrams

    def _window_ok(self, window, ts_name):
        if self._delta_threshold is None:
            return True
        for prev, cur in zip(window, window[1:]):
            if cur[ts_name] - prev[ts_name] > self._delta_threshold:
                return False
        return True

    def make_namedtuple(self, schema, ngram_as_dicts):
        """Convert a ``{offset: dict}`` window into ``{offset: namedtuple}``
        using per-timestep schema views (reference output shape)."""
        as_tuples = {}
        for offset, row in ngram_as_dicts.items():
            view = self.get_schema_at_timestep(schema, offset)
            as_tuples[offset] = view.make_namedtuple(**row)
        return as_tuples

    def get_schema_view(self, schema):
        """Flat schema view over the union of all fields this NGram touches
        (what the worker must read + decode)."""
        names = [n for n in self.get_field_names_at_all_timesteps()
                 if n in schema.fields]
        return schema.create_schema_view([schema.fields[n] for n in names])
