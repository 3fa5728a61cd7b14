"""TransformSpec: a user function applied to each row inside the reader's
workers, and the schema delta it makes.

The port's own copy of ``petastorm_tpu/schema/transform.py``. ``func``
takes a decoded row dict (``make_reader``), a dict of decoded column
arrays (``make_columnar_reader``) or a pandas DataFrame
(``make_batch_reader``) and returns the same kind;
``edit_fields`` / ``removed_fields`` / ``selected_fields`` describe the
resulting schema, so the loader sees post-transform dtypes and shapes.
"""

from __future__ import annotations

from petastorm_tpu_torch.schema.unischema import Unischema, UnischemaField


class TransformSpec:
    def __init__(self, func=None, edit_fields=None, removed_fields=None,
                 selected_fields=None):
        self.func = func
        self.edit_fields = list(edit_fields or [])
        self.removed_fields = list(removed_fields or [])
        self.selected_fields = (list(selected_fields)
                                if selected_fields is not None else None)
        if self.selected_fields is not None and self.removed_fields:
            raise ValueError("Specify only one of selected_fields and removed_fields")

    def __eq__(self, other):
        return isinstance(other, TransformSpec) and self.__dict__ == other.__dict__

    def __repr__(self):
        # Address-free, and the JAX package's string: part of the local-disk
        # cache key, whose cached rows are post-transform.
        from petastorm_tpu_torch.predicates import _func_fingerprint

        func = _func_fingerprint(self.func) if self.func is not None else None
        return (f"TransformSpec({func}, edit={self.edit_fields!r}, "
                f"removed={self.removed_fields!r}, "
                f"selected={self.selected_fields!r})")


def _as_unischema_field(field_spec):
    if isinstance(field_spec, UnischemaField):
        return field_spec
    # ('name', numpy_dtype, shape, nullable) tuples, as the reference takes
    name, numpy_dtype, shape, nullable = field_spec
    return UnischemaField(name, numpy_dtype, shape, None, nullable)


def transform_schema(schema, transform_spec):
    """``schema`` after ``transform_spec``'s delta: removed fields go, edited
    fields replace theirs in place, new fields follow in edit order, then
    ``selected_fields`` (if given) keeps only those."""
    removed = set(transform_spec.removed_fields)
    edited = {f.name: f for f in map(_as_unischema_field, transform_spec.edit_fields)}
    fields = []
    for field in schema.fields.values():
        if field.name in removed:
            continue
        fields.append(edited.pop(field.name, field))
    fields.extend(edited.values())
    if transform_spec.selected_fields is not None:
        selected = set(transform_spec.selected_fields)
        unknown = selected - {f.name for f in fields}
        if unknown:
            raise ValueError(
                f"selected_fields not in post-transform schema: {sorted(unknown)}")
        fields = [f for f in fields if f.name in selected]
    return Unischema(f"transformed_{schema._name}", fields)
