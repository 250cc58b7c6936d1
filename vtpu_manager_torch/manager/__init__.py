"""Node-side daemons: the utilization watcher."""
