from raytrace2.app import main

raise SystemExit(main())
