refreshSessions().then(() => refreshAll()).then(() => { watchLoop(); pollWorkloads(); });
