from .run import create_server, run_main
