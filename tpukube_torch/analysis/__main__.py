"""``python -m tpukube_torch.analysis [paths]`` — the lint prover's
command line (see ``cli.py``); with no path it lints the
``tpukube_torch`` package next to this install."""

from tpukube_torch.analysis.cli import main

raise SystemExit(main())
