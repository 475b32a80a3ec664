module.exports = require('./build/Release/za2node.node');
