from .server import run_server

if __name__ == "__main__":
    import logging

    logging.basicConfig(level=logging.INFO)
    run_server()
