"""Sample into CmdStan-compatible CSV files.

Mirror of nuts-rs ``examples/csv_trace.rs``: one ``chain_{i}.csv``
per chain, cartesian-product column names for tensor parameters, warmup
draws marked by negative ``sample_id`` (reference ``src/storage/csv.rs``).
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.abspath(__file__)), _os.pardir))  # repo-root import without install

import csv
import os
import tempfile

import nuts_rs_tpu as nt

from _model import make_model, make_settings, print_progress


def main():
    model = make_model()
    settings = make_settings()
    directory = tempfile.mkdtemp()

    nt.sample(model, settings, storage=nt.CsvConfig(directory=directory),
              progress_callback=print_progress)

    files = sorted(f for f in os.listdir(directory) if f.endswith(".csv"))
    print("files:", files)
    with open(os.path.join(directory, files[0])) as fh:
        rows = list(csv.reader(fh))
    header, first, last = rows[0], rows[1], rows[-1]
    print("columns:", header[:6], "...")
    print("first row sample_id:", first[0], "(negative => warmup)")
    print("last row sample_id:", last[0])
    assert len(files) == settings.num_chains
    assert int(first[0]) < 0 and int(last[0]) > 0
    assert sum(c.startswith("position.") for c in header) == model.dim


if __name__ == "__main__":
    main()
