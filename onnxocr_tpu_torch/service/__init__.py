from .http import App, TestClient, serve
from .routes import build_app
