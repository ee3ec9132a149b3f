"""Statistics table: the regression-oracle artifact.

Replicates deal.II TableHandler in auto-fill mode with
``simple_table_with_separate_column_description`` output
(reference cracks.cc:1169, 4469-4475): the ``statistics`` file is the
reference test suite's golden artifact, so the format here matches it
exactly — fixed(4) for plain doubles, scientific(8) where the reference
calls set_scientific, integers as-is, auto-fill padding with "".
"""

from __future__ import annotations


class Statistics:
    def __init__(self):
        self.columns: list[str] = []
        self.data: dict[str, list] = {}
        self.formats: dict[str, tuple] = {}  # name -> ("fixed"/"sci", prec)
        self.n_rows = 0

    def add_value(self, name: str, value):
        if name not in self.data:
            self.columns.append(name)
            self.data[name] = []
        col = self.data[name]
        max_len = max((len(self.data[c]) for c in self.columns), default=0)
        if len(col) < max_len:
            # value belongs to the current (in-progress) row max_len-1:
            # pad the column up to that row
            while len(col) < max_len - 1:
                col.append("")
        # else: len(col) == max_len -> starts a new row
        col.append(value)
        self.n_rows = max(len(self.data[c]) for c in self.columns)

    def set_scientific(self, name: str, precision: int = 8):
        self.formats[name] = ("sci", precision)

    def set_precision(self, name: str, precision: int):
        kind = self.formats.get(name, ("fixed", precision))[0]
        self.formats[name] = (kind, precision)

    def _fmt(self, name: str, value) -> str:
        if value == "":
            return '""'
        if isinstance(value, (int,)) and not isinstance(value, bool):
            return str(value)
        kind, prec = self.formats.get(name, ("fixed", 4))
        if kind == "sci":
            return f"{value:.{prec}e}"
        return f"{value:.{prec}f}"

    def write_text(self) -> str:
        out = []
        for i, name in enumerate(self.columns):
            out.append(f"# {i + 1}: {name}")
        n = max((len(self.data[c]) for c in self.columns), default=0)
        for r in range(n):
            row = []
            for c in self.columns:
                col = self.data[c]
                row.append(self._fmt(c, col[r]) if r < len(col) else '""')
            out.append(" ".join(row) + " ")
        return "\n".join(out) + "\n"

    def write(self, path: str):
        with open(path, "w") as f:
            f.write(self.write_text())
