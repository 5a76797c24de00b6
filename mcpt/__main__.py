from mcpt.cli import main

raise SystemExit(main())
